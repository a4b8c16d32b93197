"""The port's ``utils/checkpoint.py`` against the JAX package's: the same
on-disk format (a snapshot written by either package loads in the other,
arrays and manifest equal), tensors saved like arrays, and the
reference's checkpoint cases (``tests/test_utils.py``) with the same
error types and messages."""

import json
import re
import zipfile

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.utils import checkpoint as jckpt
from mpi_grid_redistribute_tpu_torch.utils import checkpoint as ckpt
from mpi_grid_redistribute_tpu_torch.service import elastic

PACKAGES = {"reference": jckpt, "port": ckpt}


def _state(rng, R=4, n_local=16):
    return {
        "pos": rng.random((R * n_local, 3)).astype(np.float32),
        "vel": rng.standard_normal((R * n_local, 3)).astype(np.float32),
        "ids": np.arange(R * n_local, dtype=np.int32),
        "count": rng.integers(0, n_local + 1, R).astype(np.int32),
    }


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference"),
                                           ("port", "port")])
def test_snapshots_cross_load(tmp_path, rng, writer, reader):
    arrays = _state(rng)
    extra = {"seed": 3, "grid_shape": [2, 2, 1]}
    PACKAGES[writer].save(str(tmp_path / "ck"), arrays, 4, step=7,
                          extra=extra)
    back, man = PACKAGES[reader].load(str(tmp_path / "ck"))
    want, want_man = jckpt.load(str(tmp_path / "ck"))
    assert man == want_man
    assert man["step"] == 7 and man["extra"] == extra
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        assert back[k].tobytes() == a.tobytes() == want[k].tobytes()


def test_both_writers_give_the_same_files(tmp_path, rng):
    """Same arrays, the same manifest (but the checksums, which cover the
    zip's member timestamps) and, in every shard, the same members with
    the same bytes from either writer (the port's compresses its shards
    on parallel threads)."""
    arrays = _state(rng)
    jckpt.save(str(tmp_path / "a"), arrays, 4, step=3, extra={"x": 1})
    ckpt.save(str(tmp_path / "b"), arrays, 4, step=3, extra={"x": 1})
    ma = json.loads((tmp_path / "a" / "manifest.json").read_text())
    mb = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert list(ma["checksums"]) == list(mb["checksums"])
    ma.pop("checksums"), mb.pop("checksums")
    assert ma == mb
    for r in range(4):
        name = f"shard_{r:05d}.npz"
        with zipfile.ZipFile(tmp_path / "a" / name) as za, \
                zipfile.ZipFile(tmp_path / "b" / name) as zb:
            assert za.namelist() == zb.namelist()
            for member in za.namelist():
                assert za.read(member) == zb.read(member)
                assert (za.getinfo(member).compress_type
                        == zb.getinfo(member).compress_type)


def test_save_takes_tensors(tmp_path, rng):
    arrays = _state(rng)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ckpt.save(str(tmp_path / "t"), tensors, 4, step=1)
    back, _ = jckpt.load(str(tmp_path / "t"))
    for k in arrays:
        assert back[k].tobytes() == arrays[k].tobytes()


def test_checkpoint_roundtrip(tmp_path, rng):
    R, n_local = 4, 16
    arrays = {
        "pos": rng.random((R * n_local, 3)).astype(np.float32),
        "ids": np.arange(R * n_local, dtype=np.int64),
        "count": np.full((R,), n_local, dtype=np.int32),
    }
    ckpt.save(str(tmp_path / "ck"), arrays, R, step=7, extra={"dt": 0.05})
    back, manifest = ckpt.load(str(tmp_path / "ck"))
    assert manifest["step"] == 7
    assert manifest["extra"]["dt"] == 0.05
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def test_checkpoint_partial_ranks(tmp_path, rng):
    R, n_local = 4, 8
    pos = rng.random((R * n_local, 3)).astype(np.float32)
    ckpt.save(str(tmp_path / "ck"), {"pos": pos}, R)
    back, _ = ckpt.load(str(tmp_path / "ck"), ranks=[2, 0])
    np.testing.assert_array_equal(
        back["pos"],
        np.concatenate([pos[2 * n_local: 3 * n_local], pos[:n_local]]),
    )
    for mod in (jckpt, ckpt):
        with pytest.raises(ValueError, match="rank 4 outside checkpoint"):
            mod.load(str(tmp_path / "ck"), ranks=[4])
        assert mod.load(str(tmp_path / "ck"), ranks=[])[0] == {}


def _message(mod, fn):
    with pytest.raises(Exception) as ei:
        fn(mod)
    return type(ei.value), str(ei.value)


@pytest.mark.parametrize("case", ["ragged", "per_shard_shape", "rows",
                                  "no_global"])
def test_save_refusals_match_reference(tmp_path, rng, case):
    R = 4
    arrays = {
        "ragged": {"pos": np.zeros((10, 3), np.float32)},
        "per_shard_shape": {"pos": np.zeros((8, 3), np.float32),
                            "count": np.ones((R, 2), np.int32)},
        "rows": {"pos": np.zeros((8, 3), np.float32),
                 "vel": np.zeros((12, 3), np.float32)},
        "no_global": {"count": np.ones((R,), np.int32)},
    }[case]
    got = _message(ckpt, lambda m: m.save(str(tmp_path / "p"), arrays, R))
    want = _message(jckpt, lambda m: m.save(str(tmp_path / "r"), arrays, R))
    assert got[0] is ValueError and got == want


def test_checkpoint_per_shard_is_by_name_not_shape(tmp_path, rng):
    R = 4
    arrays = {
        "pos": rng.random((R, 3)).astype(np.float32),  # n_local = 1
        "ids": np.arange(R, dtype=np.int64),  # global, happens to be [R]
        "count": np.ones((R,), dtype=np.int32),
    }
    ckpt.save(str(tmp_path / "ck"), arrays, R)
    back, manifest = ckpt.load(str(tmp_path / "ck"))
    assert manifest["per_shard"] == ["count"]
    assert manifest["rows_per_shard"] == 1
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def _save_small(path, rng, R=4, n_local=8, step=0, mod=ckpt):
    arrays = {
        "pos": rng.random((R * n_local, 3)).astype(np.float32),
        "count": np.full((R,), n_local, dtype=np.int32),
    }
    mod.save(str(path), arrays, R, step=step)
    return arrays


def _truncate(path):
    raw = path.read_bytes()
    path.write_bytes(raw[: len(raw) // 2])


def _bitflip(path):
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _manifest(path):
    (path.parent / "manifest.json").write_text("{not json")


def _missing_key(path):
    m = json.loads((path.parent / "manifest.json").read_text())
    del m["names"]
    (path.parent / "manifest.json").write_text(json.dumps(m))


def _missing_shard(path):
    path.unlink()


@pytest.mark.parametrize("damage,shard", [
    (_truncate, "shard_00002.npz"), (_bitflip, "shard_00001.npz"),
    (_manifest, "manifest.json"), (_missing_key, "manifest.json"),
    (_missing_shard, "shard_00003.npz"),
])
def test_corruption_errors_match_reference(tmp_path, rng, damage, shard):
    """A torn shard, a flipped byte, a broken manifest, a manifest
    without its keys, a missing shard: CheckpointCorruptError naming the
    shard, with the reference's message (directory aside)."""
    errs = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name / "ck"
        _save_small(d, np.random.default_rng(5), mod=mod)
        damage(d / (shard if shard != "manifest.json"
                    else "shard_00000.npz"))
        with pytest.raises(mod.CheckpointCorruptError) as ei:
            mod.load(str(d))
        assert ei.value.shard == shard
        # digests cover the zip's member timestamps: masked
        errs[name] = re.sub(r"[0-9a-f]{12}…", "H…",
                            str(ei.value).replace(str(d), "DIR"))
    assert errs["port"] == errs["reference"]
    if damage is _bitflip:
        assert "sha256" in errs["port"]


def test_load_latest_skips_corrupt_newest(tmp_path, rng):
    root = tmp_path / "snaps"
    good = _save_small(root / "step_00000004", rng, step=4)
    _save_small(root / "step_00000008", rng, step=8, mod=jckpt)
    bad = root / "step_00000008" / "shard_00000.npz"
    bad.write_bytes(bad.read_bytes()[:16])
    for mod in (ckpt, jckpt):
        latest = mod.load_latest(str(root))
        assert latest.manifest["step"] == 4
        assert latest.skipped == 1
        np.testing.assert_array_equal(latest.arrays["pos"], good["pos"])


def test_load_latest_none_when_all_invalid(tmp_path, rng):
    root = tmp_path / "snaps"
    _save_small(root / "step_00000002", rng, step=2)
    (root / "step_00000002" / "manifest.json").unlink()
    assert ckpt.load_latest(str(root)) is None
    assert ckpt.load_latest(str(tmp_path / "missing")) is None


def test_list_snapshots_excludes_staging_dirs(tmp_path, rng):
    root = tmp_path / "snaps"
    _save_small(root / "step_00000002", rng, step=2)
    _save_small(root / "step_00000006", rng, step=6)
    (root / "step_00000009.tmp-123").mkdir()
    (root / "step_00000004.old-123").mkdir()
    (root / "broken").mkdir()  # no manifest: listed last, counted skipped
    snaps = ckpt.list_snapshots(str(root))
    assert [s.rsplit("/", 1)[-1] for s in snaps] == [
        "step_00000006", "step_00000002", "broken",
    ]
    assert snaps == jckpt.list_snapshots(str(root))


def test_atomic_publish_replaces_an_existing_snapshot(tmp_path, rng):
    first = _save_small(tmp_path / "ck", rng, step=1)
    second = _save_small(tmp_path / "ck", rng, step=2)
    back, man = ckpt.load(str(tmp_path / "ck"))
    assert man["step"] == 2
    assert back["pos"].tobytes() == second["pos"].tobytes()
    assert back["pos"].tobytes() != first["pos"].tobytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


def test_checkpoint_elastic_restore(tmp_path, rng):
    R, n_local = 4, 16
    pos = rng.random((R * n_local, 3)).astype(np.float32)
    vel = rng.random((R * n_local, 3)).astype(np.float32)
    for nranks in (R, 2 * R, R // 2):
        d = tmp_path / f"ck_{nranks}"
        ckpt.save(
            str(d),
            {"pos": pos, "vel": vel,
             "count": np.full((nranks,), R * n_local // nranks, np.int32)},
            nranks,
        )
        back, manifest = ckpt.load(str(d))
        assert manifest["nranks"] == nranks
        np.testing.assert_array_equal(back["pos"], pos)
        np.testing.assert_array_equal(back["vel"], vel)


def test_gather_live_matches_reference_and_is_reexported(rng):
    from mpi_grid_redistribute_tpu.utils.checkpoint import (
        gather_live as jgather,
    )

    arrays = _state(rng)
    got = ckpt.gather_live(arrays, 4, 16)
    want = jgather(arrays, 4, 16)
    assert got.keys() == want.keys()
    for k in got:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    assert elastic.gather_live is ckpt.gather_live
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert ckpt.gather_live(tensors, 4, 16)["pos"].tobytes() == \
        got["pos"].tobytes()
    for bad in ({"count": np.zeros(3, np.int32)},
                {"count": np.full(4, 17, np.int32)}):
        a = dict(arrays, **bad)
        with pytest.raises(ValueError) as e1:
            ckpt.gather_live(a, 4, 16)
        with pytest.raises(ValueError) as e2:
            jgather(a, 4, 16)
        assert str(e1.value) == str(e2.value)
