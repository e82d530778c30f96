"""The port's command line (cli.py) on the CPU (``--device cpu``).

``render`` at 24x24 and 2 spp against the JAX package's CLI within the
goldens' bar (RMSE < 2/255 of the display values), and against the port's
``Renderer`` with the same settings on every pixel; a checkpoint and resume
against one go; the debug views; ``info`` JSON equal to the JAX CLI's on an
exported tessellated box; ``export`` equal to the JAX CLI's. The JAX side
runs its NumPy loaders (its native library patched off, as its own
tests/test_flatten_native.py does): its C++ SAH build makes another tree on
tessellated scenes, and the port holds to the NumPy tree.
"""

import json
import math
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu import cli as JCLI
from wgpu_path_tracing_tpu.accel import native as JNATIVE
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu_torch import (
    Camera,
    Renderer,
    RenderConfig,
    cornell_box,
    load_model,
)
from wgpu_path_tracing_tpu_torch import cli
from wgpu_path_tracing_tpu_torch.utils.image import read_exr, read_png, rmse

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SPP = 24, 2
GOLDEN_BAR = 2.0 / 255.0  # tests/test_golden.py's RMSE bar
SMALL = ["--width", str(SIZE), "--height", str(SIZE)]


@pytest.fixture()
def jax_numpy(monkeypatch):
    """The JAX loaders on their NumPy paths."""
    monkeypatch.setattr(JNATIVE, "native_available", lambda: False)
    monkeypatch.setattr(JG, "native_available", lambda: False)


def port_render(tmp_path, *args):
    out = str(tmp_path / "port.png")
    assert cli.main(["render", *args, "--device", "cpu", *SMALL, "-o", out]) == 0
    return read_png(out)


def renderer_png(tmp_path, scene, spp=SPP, **config):
    """The PNG an in-process ``Renderer`` writes from the CLI's settings
    (its default camera: 60 degrees of fov, the reference's aperture and
    focus distance)."""
    cam = Camera(width=SIZE, height=SIZE, aspect=1.0, fov=math.radians(60.0),
                 aperture=0.001, focus_distance=5.0)
    r = Renderer(RenderConfig(width=SIZE, height=SIZE, **config), cam,
                 device="cpu")
    r.load_scene(scene)
    out = str(tmp_path / "renderer.png")
    if r.config.mode == "pt":
        r.render(spp)
        r.save_png(out)
    else:
        from wgpu_path_tracing_tpu_torch.utils.image import write_png
        write_png(out, np.clip(r.render_debug(), 0, 1)[::-1])
    return read_png(out)


def test_render_equals_the_renderer(tmp_path):
    got = port_render(tmp_path, "cornell", "--spp", str(SPP))
    np.testing.assert_array_equal(got, renderer_png(tmp_path, cornell_box()))


def test_render_as_a_module(tmp_path):
    """``python -m wgpu_path_tracing_tpu_torch.cli`` writes the same PNG."""
    out = tmp_path / "module.png"
    proc = subprocess.run(
        [sys.executable, "-m", "wgpu_path_tracing_tpu_torch.cli", "render",
         "cornell", "--device", "cpu", "--spp", str(SPP), *SMALL,
         "-o", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert f"{SPP} spp" in proc.stdout and "on cpu" in proc.stdout
    np.testing.assert_array_equal(read_png(str(out)),
                                  renderer_png(tmp_path, cornell_box()))


def jax_render(tmp_path, *args):
    out = str(tmp_path / "jax.png")
    assert JCLI.main(["render", *args, *SMALL, "-o", out]) == 0
    return read_png(out)


def test_render_within_the_golden_bar_of_the_jax_cli(tmp_path, jax_numpy):
    got = port_render(tmp_path, "cornell", "--spp", str(SPP))
    ref = jax_render(tmp_path, "cornell", "--spp", str(SPP))
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert rmse(got, ref) < GOLDEN_BAR


@pytest.mark.parametrize("mode", ["normal", "bvh_depth"])
def test_debug_views(mode, tmp_path, jax_numpy):
    """Each view equals the Renderer's on every pixel. Against the JAX CLI:
    the depth view on every pixel; the normal view but for at most 3 edge
    pixels, where the two packages' centre rays meet different triangles
    (tests/test_torch_debug.py arbitrates those with the scalar oracle)."""
    got = port_render(tmp_path, "cornell", "--mode", mode)
    np.testing.assert_array_equal(
        got, renderer_png(tmp_path, cornell_box(), mode=mode))
    ref = jax_render(tmp_path, "cornell", "--mode", mode)
    apart = (got != ref).any(-1).sum()
    assert apart <= (3 if mode == "normal" else 0), apart


def test_checkpoint_and_resume_equal_one_go(tmp_path):
    ckpt = str(tmp_path / "run.npz")
    half = port_render(tmp_path, "cornell", "--spp", "1",
                       "--checkpoint", ckpt)
    resumed = port_render(tmp_path, "cornell", "--spp", "2",
                          "--checkpoint", ckpt, "--resume")
    assert not np.array_equal(half, resumed)
    np.testing.assert_array_equal(resumed,
                                  renderer_png(tmp_path, cornell_box()))
    with np.load(ckpt) as data:
        assert int(data["frame_index"]) == 2


def test_render_writes_linear_radiance_and_previews(tmp_path):
    """--exr and --hdr write the accumulation the Renderer's writers
    write; --preview refreshes a PNG every chunk."""
    exr, hdr = str(tmp_path / "a.exr"), str(tmp_path / "a.hdr")
    preview = str(tmp_path / "preview.png")
    got = port_render(tmp_path, "cornell", "--spp", "2", "--chunk", "1",
                      "--exr", exr, "--hdr", hdr, "--preview", preview)
    np.testing.assert_array_equal(read_png(preview), got)
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cpu")
    r.load_scene(cornell_box())
    r.render(2)
    r.save_exr(str(tmp_path / "b.exr"))
    np.testing.assert_array_equal(read_exr(exr),
                                  read_exr(str(tmp_path / "b.exr")))
    assert os.path.getsize(hdr) > 0


def test_render_a_glb_with_a_forced_intersector(tmp_path):
    glb = str(tmp_path / "box.glb")
    assert cli.main(["export", "cornell", "--tessellation", "3",
                     "-o", glb]) == 0
    got = port_render(tmp_path, glb, "--spp", "1", "--intersector", "walk")
    np.testing.assert_array_equal(
        got, renderer_png(tmp_path, load_model(glb), spp=1,
                          intersector="walk"))


def test_info_equals_the_jax_cli(tmp_path, capsys, jax_numpy):
    glb = str(tmp_path / "box.glb")
    assert cli.main(["export", "cornell", "--tessellation", "6",
                     "-o", glb]) == 0
    capsys.readouterr()
    assert cli.main(["info", glb]) == 0
    got = json.loads(capsys.readouterr().out)
    assert JCLI.main(["info", glb]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert got["triangles"] == load_model(glb).num_triangles > 36


def glb_chunks(data: bytes):
    """(JSON document, BIN chunk) of GLB bytes."""
    jlen, = struct.unpack_from("<I", data, 12)
    blen, = struct.unpack_from("<I", data, 20 + jlen)
    return json.loads(data[20:20 + jlen]), data[28 + jlen:28 + jlen + blen]


@pytest.mark.parametrize("scene", ["cornell", "textured"])
def test_export_equals_the_jax_cli(scene, tmp_path, jax_numpy):
    """The same glTF document but for ``asset.generator`` (each package
    names itself) and the same binary chunk, bytes for bytes, for the
    cornell box; for the textured box the PNG images are encoded by the
    port's own writer (other bytes, the same pixels), so its image views'
    lengths differ, its other views are equal and its images decode
    equal."""
    out, jout = str(tmp_path / "port.glb"), str(tmp_path / "jax.glb")
    assert cli.main(["export", scene, "-o", out]) == 0
    assert JCLI.main(["export", scene, "-o", jout]) == 0
    doc, blob = glb_chunks(open(out, "rb").read())
    jdoc, jblob = glb_chunks(open(jout, "rb").read())
    assert doc.pop("asset")["generator"] == "wgpu_path_tracing_tpu_torch"
    assert jdoc.pop("asset")["generator"] == "wgpu_path_tracing_tpu"
    images = {img["bufferView"] for img in doc.get("images", [])}
    if scene == "cornell":
        assert doc == jdoc and blob == jblob and not images
        return
    for key in set(doc) | set(jdoc):
        if key not in ("bufferViews", "buffers"):
            assert doc[key] == jdoc[key], key
    assert images
    for i, (v, jv) in enumerate(zip(doc["bufferViews"], jdoc["bufferViews"])):
        a = blob[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]
        b = jblob[jv["byteOffset"]:jv["byteOffset"] + jv["byteLength"]]
        if i not in images:
            assert a == b, f"bufferView {i}"
            continue
        pa, pb = tmp_path / "a.png", tmp_path / "b.png"
        pa.write_bytes(a)
        pb.write_bytes(b)
        np.testing.assert_array_equal(read_png(str(pa)), read_png(str(pb)))


def test_view_runs_the_viewer_for_a_time(capsys):
    """``view --seconds 0`` serves on a free port, ticks once and stops."""
    assert cli.main(["view", "cornell", "--device", "cpu", "--width", "8",
                     "--height", "8", "--chunk", "1", "--port", "0",
                     "--seconds", "0"]) == 0
    assert "viewer at http://localhost:" in capsys.readouterr().err


def test_unknown_export_scene_fails(tmp_path, capsys):
    assert cli.main(["export", "teapot", "-o", str(tmp_path / "t.glb")]) == 2
    assert "unknown scene" in capsys.readouterr().out
