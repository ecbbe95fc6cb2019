import os

import numpy as np
import pytest

from tpulbm.core.params import LBMParams
from tpulbm.io import native
from tpulbm.io.obstacles import ObstacleFileError, read_obstacles, write_obstacles
from tpulbm.io.params_file import ParamFileError, read_params
from tpulbm.io.writers import write_av_vels, write_final_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA = os.path.join(REPO, "data")


def test_read_params_128():
    p = read_params(os.path.join(DATA, "input_128x128.params"))
    assert (p.nx, p.ny, p.max_iters, p.reynolds_dim) == (128, 128, 40000, 10)
    assert (p.density, p.accel, p.omega) == (0.1, 0.005, 1.85)


def test_read_params_1024():
    p = read_params(os.path.join(DATA, "input_1024x1024.params"))
    assert (p.nx, p.ny, p.max_iters) == (1024, 1024, 20000)
    assert p.accel == 0.01


def test_read_params_errors(tmp_path):
    bad = tmp_path / "bad.params"
    bad.write_text("128\n128\n")
    with pytest.raises(ParamFileError):
        read_params(bad)


def test_read_obstacles_counts():
    # 128x128 deck has 512 obstacle entries of which 508 are unique;
    # duplicates count once (d2q9-bgk.c:945-947).
    mask, num_free = read_obstacles(
        os.path.join(DATA, "obstacles_128x128.dat"), 128, 128
    )
    assert mask.shape == (128, 128)
    assert mask.sum() == 508
    assert num_free == 128 * 128 - 508 == 15876


def test_read_obstacles_errors(tmp_path):
    bad = tmp_path / "bad.dat"
    bad.write_text("5 5 2\n")
    with pytest.raises(ObstacleFileError):
        read_obstacles(bad, 8, 8)
    bad.write_text("9 5 1\n")
    with pytest.raises(ObstacleFileError):
        read_obstacles(bad, 8, 8)


def test_obstacles_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    mask = rng.rand(16, 32) < 0.2
    path = tmp_path / "obst.dat"
    write_obstacles(path, mask)
    mask2, num_free = read_obstacles(path, 32, 16)
    assert np.array_equal(mask, mask2)
    assert num_free == mask.size - mask.sum()


def test_native_obstacle_parser_matches_numpy():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    for name, nx, ny in [("obstacles_128x128.dat", 128, 128),
                         ("obstacles_1024x1024.dat", 1024, 1024)]:
        path = os.path.join(DATA, name)
        mask_np, free_np = read_obstacles(path, nx, ny)
        mask_c, free_c = native.read_obstacles(path, nx, ny)
        assert np.array_equal(mask_np, mask_c)
        assert free_np == free_c


def _tiny_params():
    return LBMParams(nx=4, ny=3, max_iters=4, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85,
                     free_cells_inv=1.0 / 11).with_free_cells(11)


def test_final_state_format(tmp_path):
    p = _tiny_params()
    f = np.full((9, 3, 4), 0.0123, dtype=np.float32)
    obst = np.zeros((3, 4), dtype=bool)
    obst[0, 1] = True
    path = tmp_path / "final_state.dat"
    write_final_state(path, f, obst, p)
    lines = path.read_text().splitlines()
    assert len(lines) == 12
    # y-major ascending coordinate order (d2q9-bgk.c:1071-1115).
    assert lines[0].split()[:2] == ["0", "0"]
    assert lines[1].split()[:2] == ["1", "0"]
    assert lines[4].split()[:2] == ["0", "1"]
    # Obstacle line: zeros + ambient pressure + flag 1.
    cols = lines[1].split()
    assert cols[-1] == "1"
    assert float(cols[2]) == 0.0 and float(cols[4]) == 0.0
    np.testing.assert_allclose(float(cols[5]), 0.1 / 3.0, rtol=1e-6)
    # Free cell at rest: u = 0, pressure = 9*0.0123/3.
    cols = lines[0].split()
    assert cols[-1] == "0"
    np.testing.assert_allclose(float(cols[5]), 9 * 0.0123 / 3.0, rtol=1e-5)
    # %.12E fixed-width formatting as the reference (d2q9-bgk.c:1115).
    for c in cols[2:6]:
        mantissa, exp = c.split("E")
        assert len(mantissa.lstrip("-").split(".")[1]) == 12


def test_av_vels_format(tmp_path):
    path = tmp_path / "av_vels.dat"
    write_av_vels(path, np.array([1.094269153342e-05, 2.5e-3], dtype=np.float32))
    lines = path.read_text().splitlines()
    assert lines[0].startswith("0:\t") and lines[1].startswith("1:\t")
    assert "E-" in lines[0]
    val = float(lines[0].split("\t")[1])
    np.testing.assert_allclose(val, 1.094269153342e-05, rtol=1e-6)


def test_native_and_python_writers_identical(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("native toolchain unavailable")
    p = _tiny_params()
    rng = np.random.RandomState(1)
    f = rng.rand(9, 3, 4).astype(np.float32) * 0.1
    obst = rng.rand(3, 4) < 0.3
    av = rng.rand(100).astype(np.float32) * 1e-3

    a, a2 = tmp_path / "native.dat", tmp_path / "av_native.dat"
    write_final_state(a, f, obst, p)
    write_av_vels(a2, av)

    monkeypatch.setattr(native, "available", lambda: False)
    b, b2 = tmp_path / "python.dat", tmp_path / "av_python.dat"
    write_final_state(b, f, obst, p)
    write_av_vels(b2, av)

    assert a.read_text() == b.read_text()
    assert a2.read_text() == b2.read_text()


def test_make_deck_matches_reference_geometry(tmp_path):
    """Generated decks reproduce the shipped decks' closed-box geometry."""
    from tpulbm.tools.make_deck import box_obstacles, make_deck

    ref_mask, _ = read_obstacles(
        os.path.join(DATA, "obstacles_128x128.dat"), 128, 128
    )
    gen = box_obstacles(128, 128)
    # shipped deck == closed box (plus its 4 duplicate entries, maskwise equal)
    assert np.array_equal(ref_mask, gen)

    ppath, opath = make_deck(256, 64, 100, out_dir=tmp_path,
                             blocks=[(10, 20, 5, 8)])
    from tpulbm.io.params_file import read_params
    p = read_params(ppath)
    assert (p.nx, p.ny, p.max_iters) == (256, 64, 100)
    mask, num_free = read_obstacles(opath, 256, 64)
    assert mask[0].all() and mask[-1].all() and mask[:, 0].all()
    assert mask[12, 24] and not mask[12, 30]


def test_native_writers_concurrent_threads(tmp_path):
    """The native writers must be safe from concurrent Python threads
    (ctypes releases the GIL; buffers are per-stream heap allocations)."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    import threading

    p = _tiny_params()
    rng = np.random.RandomState(7)
    cases = []
    for i in range(4):
        f = rng.rand(9, 3, 4).astype(np.float32) * 0.1
        obst = rng.rand(3, 4) < 0.3
        cases.append((f, obst))

    # sequential ground truth
    seq = []
    for i, (f, obst) in enumerate(cases):
        path = tmp_path / f"seq{i}.dat"
        write_final_state(path, f, obst, p)
        seq.append(path.read_text())

    threads = []
    for i, (f, obst) in enumerate(cases):
        t = threading.Thread(
            target=write_final_state,
            args=(tmp_path / f"par{i}.dat", f, obst, p),
        )
        threads.append(t)
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        assert (tmp_path / f"par{i}.dat").read_text() == seq[i], i
