"""The port's fly-camera Controller (render/controller.py) and HTTP viewer
(viewer.py) on ``Renderer(device="cpu")``.

The cases of the JAX package's tests/test_controller.py (WASD, vertical and
shift, look restarts the accumulation, pinch dolly), and the camera after
the same events against the JAX ``Controller`` on the JAX ``Renderer``:
both move the camera in NumPy float32 by the same formulas, so position and
basis are held to 1e-6 absolute (they agree exactly here). Then the HTTP
viewer driving the controller, and scene swaps by ``POST /load`` of a path
and of ``scene_to_glb`` bytes, each installed at a chunk boundary.
"""

import glob
import json
import math
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.render import controller as JC
from wgpu_path_tracing_tpu_torch import (
    Controller,
    Renderer,
    RenderConfig,
    cornell_box,
    scene_to_glb,
)
from wgpu_path_tracing_tpu_torch.render import controller as C
from wgpu_path_tracing_tpu_torch.utils.image import read_png
from wgpu_path_tracing_tpu_torch.viewer import ViewerServer

torch.set_num_threads(1)

ATOL = 1e-6  # camera position and basis, port against JAX
BASIS = ("position", "forward", "right", "up")


def make_renderer(size=8, scene=None):
    r = Renderer(RenderConfig(width=size, height=size, frames_per_chunk=2),
                 device="cpu")
    r.load_scene(cornell_box() if scene is None else scene)
    return r


@pytest.fixture()
def renderer():
    return make_renderer()


def test_constants_equal_jax():
    assert (C.MOVE_SPEED, C.ROTATE_SPEED, C.PINCH_DOLLY_SCALE) == (
        JC.MOVE_SPEED, JC.ROTATE_SPEED, JC.PINCH_DOLLY_SCALE)


def test_wasd_translation(renderer):
    c = Controller(renderer)
    start = renderer.camera.position.copy()
    c.key_down("w")
    c.update(0.5)  # 2.0 units/s * 0.5 s forward
    np.testing.assert_allclose(renderer.camera.position,
                               start + np.array([0, 0, -1.0]), atol=ATOL)
    c.key_up("w")
    c.key_down("d")
    c.update(0.25)  # right 0.5
    np.testing.assert_allclose(renderer.camera.position,
                               start + np.array([0.5, 0, -1.0]), atol=ATOL)


def test_vertical_and_shift(renderer):
    c = Controller(renderer)
    start = renderer.camera.position.copy()
    c.key_down(" ")
    c.update(1.0)
    c.key_up(" ")
    c.key_down("Shift")
    c.update(0.5)
    np.testing.assert_allclose(renderer.camera.position,
                               start + np.array([0, 1.0, 0]), atol=ATOL)


def test_mouse_look_resets_accumulation(renderer):
    renderer.render(spp=2)
    assert renderer.frame_index == 2
    c = Controller(renderer)
    c.mouse_move(10.0, 0.0)
    c.update(0.1)
    # yaw = 10 * -pi/18 * 0.1 (controller.ts:163-166)
    expected_yaw = 10 * -(math.pi / 18) * 0.1
    assert renderer.frame_index == 0
    # rotating (0, 0, -1) about +Y by yaw: x' = -sin(yaw)
    np.testing.assert_allclose(renderer.camera.forward[0],
                               -math.sin(expected_yaw), atol=1e-5)
    c.update(0.1)  # the deltas were consumed
    assert renderer.frame_index == 0


def test_pinch_dolly(renderer):
    """Two-finger pinch (controller.ts:85-101): delta-distance * 0.001
    dollies forward at once, outside the per-frame update."""
    c = Controller(renderer)
    start = renderer.camera.position.copy()
    renderer.render(spp=2)
    c.pinch(500.0)  # fingers spread 500 px: 0.5 units forward
    np.testing.assert_allclose(renderer.camera.position,
                               start + np.array([0, 0, -0.5]), atol=ATOL)
    assert renderer.frame_index == 0  # the motion restarted accumulation
    renderer.render(spp=2)
    c.pinch(0.0)  # no motion: no restart
    assert renderer.frame_index == 2
    c.touch_move(10.0, 0.0)  # one finger feeds the mouse's path
    c.update(0.1)
    assert renderer.frame_index == 0


EVENTS = {
    "fly": [("key_down", "w"), ("update", 0.3), ("key_down", "a"),
            ("update", 0.2), ("key_up", "w"), ("key_down", " "),
            ("update", 0.1), ("key_up", " "), ("key_down", "q"),
            ("update", 0.05)],
    "look": [("mouse_move", 25.0, -7.0), ("update", 1 / 60),
             ("touch_move", -3.0, 12.0), ("update", 0.5),
             ("mouse_move", 400.0, 900.0), ("update", 0.2)],
    "mixed": [("key_down", "s"), ("mouse_move", 13.0, 2.0), ("update", 0.4),
              ("pinch", 250.0), ("key_up", "s"), ("key_down", "d"),
              ("key_down", "Shift"), ("mouse_move", -40.0, 5.0),
              ("update", 0.7), ("pinch", -75.0)],
}


@pytest.mark.parametrize("events", sorted(EVENTS))
def test_camera_equals_jax_after_the_same_events(events):
    port = make_renderer()
    ref = JRenderer(JRenderConfig(width=8, height=8, frames_per_chunk=2))
    ref.load_scene(jcornell_box())
    controllers = (Controller(port), JC.Controller(ref))
    for name, *args in EVENTS[events]:
        for c in controllers:
            getattr(c, name)(*args)
    for key in BASIS:
        np.testing.assert_allclose(getattr(port.camera, key),
                                   getattr(ref.camera, key), rtol=0,
                                   atol=ATOL, err_msg=key)
    assert port.frame_index == ref.frame_index == 0


def get(url):
    return urllib.request.urlopen(url, timeout=30).read()


def post(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=30).read()


def test_http_viewer_drives_controller(tmp_path):
    """Frames served, key, look and pinch input move the camera and restart
    the accumulation, the denoise toggle filters the published copy only."""
    r = make_renderer(16)
    server = ViewerServer(r, port=0, frames_per_update=2)
    try:
        base = f"http://127.0.0.1:{server.port}"
        server.step(1 / 60)  # one tick: a frame exists
        png = get(f"{base}/frame.png")
        assert png[:4] == b"\x89PNG"
        (tmp_path / "frame.png").write_bytes(png)
        img = read_png(str(tmp_path / "frame.png"))
        assert img.shape == (16, 16, 3)
        assert b"frame.png" in get(base)
        stats = json.loads(get(f"{base}/stats"))
        assert stats["spp"] == 2 and stats["load_error"] is None

        pos0 = r.camera.position.copy()
        get(f"{base}/key?k=w&down=1")
        server.step(0.5)  # apply the input, render
        get(f"{base}/key?k=w&down=0")
        assert not np.allclose(r.camera.position, pos0)  # flew forward
        assert r.frame_index == 2  # restarted, then one tick of 2 spp
        assert json.loads(get(f"{base}/stats"))["motion_to_frame_ms"] > 0

        fwd0 = r.camera.forward.copy()
        get(f"{base}/look?dx=30&dy=0")
        server.step(1 / 60)
        assert not np.allclose(r.camera.forward, fwd0)  # looked around

        pos1 = r.camera.position.copy()
        get(f"{base}/pinch?d=500")
        server.step(1 / 60)  # wheel or pinch dolly
        assert not np.allclose(r.camera.position, pos1)

        get(f"{base}/denoise?on=1")
        assert server.denoise
        fi = r.frame_index
        server.step(1 / 60)
        assert get(f"{base}/frame.png")[:4] == b"\x89PNG"
        assert r.frame_index == fi + 2  # the accumulation advanced as usual
        get(f"{base}/denoise?on=0")
        assert not server.denoise
        with pytest.raises(urllib.error.HTTPError) as err:
            get(f"{base}/nowhere")
        assert err.value.code == 404
    finally:
        server.stop()


def wait_for(future):
    future.result(timeout=120)
    deadline = time.perf_counter() + 30
    while not future.done() and time.perf_counter() < deadline:
        time.sleep(0.01)


def test_http_viewer_scene_swap(tmp_path):
    """The drag-drop flow (App.tsx:12-34): POST /load with a path, then with
    the .glb bytes of ``scene_to_glb(cornell_box())``; each scene is read
    off the render thread and installed at the next chunk boundary, with
    the mean restarted; the upload's temporary file goes when the load
    settles. Each load's worker reads the scene only once the tick that
    started it has rendered, so the scene is installed at the start of the
    next tick on every run: 2 frames after it, not the 8 of four ticks on
    one scene."""
    r = make_renderer(8, cornell_box(tessellation=2))
    n_box = r.scene.num_triangles
    tick_done = threading.Event()
    read_model = r._read_model

    def gated_read(p):
        if not tick_done.wait(timeout=120):
            raise TimeoutError("the tick that started the load never ended")
        return read_model(p)

    r._read_model = gated_read
    data = scene_to_glb(cornell_box())
    path = tmp_path / "cornell.glb"
    path.write_bytes(data)
    server = ViewerServer(r, port=0, frames_per_update=2)
    try:
        base = f"http://127.0.0.1:{server.port}"
        server.step(1 / 60)
        server.step(1 / 60)
        assert r.frame_index == 4
        assert post(f"{base}/load?path={path}") == b"staged"
        server.step(1 / 60)  # starts the load
        assert r.frame_index == 6 and r.scene.num_triangles == n_box
        tick_done.set()
        wait_for(server.loads[-1])
        server.step(1 / 60)  # installed at this tick's start
        assert r.scene.num_triangles == 36 != n_box
        assert r.frame_index == 2

        r.load_scene(cornell_box(tessellation=2))
        server.step(1 / 60)
        server.step(1 / 60)
        assert r.frame_index == 4
        before = set(glob.glob(os.path.join(tempfile.gettempdir(), "*.glb")))
        tick_done.clear()
        assert post(f"{base}/load", data) == b"staged"
        server.step(1 / 60)
        assert r.frame_index == 6
        tick_done.set()
        wait_for(server.loads[-1])
        server.step(1 / 60)
        assert r.scene.num_triangles == 36
        assert r.frame_index == 2
        assert json.loads(get(f"{base}/stats"))["spp"] == r.frame_index
        leaked = set(glob.glob(os.path.join(tempfile.gettempdir(),
                                            "*.glb"))) - before
        assert not leaked, leaked

        with pytest.raises(urllib.error.HTTPError) as err:
            post(f"{base}/load")  # neither a path nor a body
        assert err.value.code == 400
    finally:
        server.stop()


def test_http_viewer_reports_a_failed_load(tmp_path):
    """A load that fails is reported in /stats; the viewer renders on."""
    r = make_renderer(8)
    server = ViewerServer(r, port=0, frames_per_update=2)
    try:
        base = f"http://127.0.0.1:{server.port}"
        server.step(1 / 60)
        post(f"{base}/load?path={tmp_path / 'missing.glb'}")
        server.step(1 / 60)
        with pytest.raises(FileNotFoundError):
            server.loads[-1].result(timeout=60)
        server.step(1 / 60)  # the failure surfaces here
        assert "load_model_async failed" in json.loads(
            get(f"{base}/stats"))["load_error"]
        fi = r.frame_index
        server.step(1 / 60)
        assert r.frame_index == fi + 2 and r.scene.num_triangles == 36
    finally:
        server.stop()
