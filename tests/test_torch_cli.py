"""The port's command-line renderer (``python -m swf_renderer_tpu_torch``)
on the CPU: ``main(argv, device="cpu")`` writes what the port renders in
process, keeps the JAX CLI's options and argument errors, and writes
``--wav`` tracks byte-equal to the JAX CLI's (``tests/test_torch_audio.py``
holds the sound movie); run as a module it imports no JAX and, with no
card, raises instead of falling back to the CPU."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from swf_renderer_tpu import __main__ as jcli
from swf_renderer_tpu_torch import __main__ as cli
from swf_renderer_tpu_torch.runtime import movie
from swf_renderer_tpu_torch.utils import movie_scenes
from swf_renderer_tpu_torch.utils.pam import pam_to_rgba
from swf_renderer_tpu_torch.utils.png import read_png
from tests.test_torch_masks import levels

REPO = pathlib.Path(__file__).resolve().parent.parent
W, H = 96, 64


@pytest.fixture(scope="module")
def movies(tmp_path_factory):
    d = tmp_path_factory.mktemp("movies")
    mods = movie_scenes.port_mods()
    anim = d / "anim.swf"
    anim.write_bytes(movie_scenes.anim_movie(mods, W, H, frames=4)[0])
    still = d / "still.swf"
    still.write_bytes(movie_scenes.still_movie(mods, W, H)[0])
    return anim, still


def test_cli_writes_the_in_process_renders(movies, tmp_path, capsys):
    anim, still = movies
    out_png, out_pam = tmp_path / "still.png", tmp_path / "still.pam"
    want = movie.render_movie(still, device="cpu")
    assert cli.main([str(still), "-o", str(out_png)], device="cpu") == 0
    assert np.array_equal(read_png(out_png), want)
    assert cli.main([str(still), "-o", str(out_pam), "--stats"],
                    device="cpu") == 0
    assert np.array_equal(pam_to_rgba(out_pam.read_bytes()), want)
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert (stats["width"], stats["height"]) == (W, H)
    # The default output path is <input>.png.
    assert cli.main([str(still)], device="cpu") == 0
    assert np.array_equal(read_png(str(still) + ".png"), want)
    frames_dir = tmp_path / "frames"
    frames = movie.render_movie_timeline(anim, device="cpu")
    assert cli.main([str(anim), "--frames", str(frames_dir), "--stats"],
                    device="cpu") == 0
    written = sorted(frames_dir.glob("*.png"))
    assert [p.name for p in written] == [f"{i:04d}.png" for i in range(4)]
    for p, f in zip(written, frames):
        assert np.array_equal(read_png(p), f)
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert (stats["frames"], stats["width"], stats["height"]) == (4, W, H)


def _tags(tmp_path):
    """A shape, a morph and a bitmap ast.json, written by hand."""
    def color(r, g, b, a=255):
        return {"r": r, "g": g, "b": b, "a": a}

    def vec(x, y):
        return {"x": x, "y": y}

    shape = {
        "type": "define-shape", "id": 1,
        "bounds": {"x_min": 20, "x_max": 1220, "y_min": 40, "y_max": 900},
        "shape": {
            "initial_styles": {"fill": [{"type": "solid",
                                         "color": color(200, 40, 30)}],
                               "line": []},
            "records": [
                {"type": "style-change", "move_to": vec(20, 40),
                 "left_fill": 1},
                {"type": "edge", "delta": vec(1200, 100)},
                {"type": "edge", "delta": vec(-300, 760),
                 "control_delta": vec(100, 400)},
                {"type": "edge", "delta": vec(-900, -860)}]}}
    morph = {
        "type": "define-morph-shape", "id": 2,
        "bounds": {"x_min": 0, "x_max": 1000, "y_min": 0, "y_max": 800},
        "morph_bounds": {"x_min": 0, "x_max": 1000, "y_min": 0,
                         "y_max": 800},
        "shape": {
            "initial_styles": {"fill": [{
                "type": "solid", "color": color(10, 200, 30),
                "morph_color": color(10, 30, 200, 128)}], "line": []},
            "records": [
                {"type": "style-change", "move_to": vec(0, 0),
                 "morph_move_to": vec(200, 100), "left_fill": 1},
                {"type": "edge", "delta": vec(1000, 0),
                 "morph_delta": vec(600, 300)},
                {"type": "edge", "delta": vec(-500, 800),
                 "morph_delta": vec(-400, 400)},
                {"type": "edge", "delta": vec(-500, -800),
                 "morph_delta": vec(-200, -700)}]}}
    rng = np.random.default_rng(4)
    pal = rng.integers(0, 256, (4, 3), np.uint8)
    idx = rng.integers(0, 4, (6, 8), np.uint8)
    import struct
    import zlib

    data = (bytes([3]) + struct.pack("<HH", 8, 6) + bytes([3])
            + zlib.compress(pal.tobytes() + idx.tobytes()))
    bitmap = {"type": "define-bitmap", "id": 3, "width": 8, "height": 6,
              "media_type": "image/x-swf-bmp", "data": data.hex()}
    paths = []
    for name, tag in (("shape", shape), ("morph", morph),
                      ("bitmap", bitmap)):
        p = tmp_path / f"{name}.ast.json"
        p.write_text(json.dumps(tag))
        paths.append(p)
    return paths


def test_cli_ast_json_matches_the_jax_cli(tmp_path):
    shape, morph, bitmap = _tags(tmp_path)
    for argv in ([str(shape), "--scale", "2"], [str(shape)],
                 [str(morph), "--ratio", "0.4"], [str(bitmap)],
                 [str(shape), "--bitmap", str(bitmap)]):
        got_path, want_path = tmp_path / "port.png", tmp_path / "jax.png"
        assert cli.main(argv + ["-o", str(got_path)], device="cpu") == 0
        assert jcli.main(argv + ["-o", str(want_path)]) == 0
        got, want = read_png(got_path), read_png(want_path)
        assert got.shape == want.shape, argv
        straight, premul, _ = levels(want, got)
        assert premul <= 1 and straight <= 1, (argv, straight, premul)


def _error_line(fn, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        fn(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


def test_cli_argument_errors_are_the_jax_clis(movies, tmp_path, capsys):
    anim, _still = movies
    json_path = str(tmp_path / "whatever.json")
    for argv in ([str(anim), "--scale", "2"], [str(anim), "--ratio", "0.5"],
                 [str(anim), "--bitmap", json_path],
                 [json_path, "--frames", str(tmp_path)],
                 [json_path, "--wav", str(tmp_path / "a.wav")]):
        got = _error_line(lambda a: cli.main(a, device="cpu"), argv, capsys)
        assert got == _error_line(jcli.main, argv, capsys), argv


def test_cli_wav_names_the_audio_item(movies, tmp_path, capsys):
    """``--wav`` on a movie without sounds: both CLIs write the same
    silent track (one frame's samples at 30 fps), print its path and
    render nothing."""
    anim, _still = movies
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    assert cli.main([str(anim), "--wav", str(a)], device="cpu") == 0
    assert capsys.readouterr().out.strip() == str(a)
    assert jcli.main([str(anim), "--wav", str(b)]) == 0
    assert capsys.readouterr().out.strip() == str(b)
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_bytes()) == 44 + 4 * 5880   # 4 frames, 44.1 kHz
    assert not pathlib.Path(str(anim) + ".png").exists()


def _run_module(args, cwd):
    """``python -m swf_renderer_tpu_torch ARGS`` with JAX and the JAX
    package unimportable."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['swf_renderer_tpu'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.argv = ['swf_renderer_tpu_torch'] + {list(args)!r}\n"
        "runpy.run_module('swf_renderer_tpu_torch', run_name='__main__',\n"
        "                 alter_sys=True)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=cwd,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_module_runs_without_jax_and_needs_a_card(movies, tmp_path):
    anim, _still = movies
    proc = _run_module(["--help"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "swf_renderer_tpu_torch" in proc.stdout and "--frames" in \
        proc.stdout
    proc = _run_module([str(anim), "-o", str(tmp_path / "x.png")], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "jax" not in proc.stderr.lower().replace("swf_renderer_tpu", "")
    assert not (tmp_path / "x.png").exists()
