"""The port's scene export (``utils/playback.py``) and live view
(``utils/liveview.py``) against the JAX package's.

The scene dict (geometry list and the keyframed poses, rounded to 1e-6 as
both packages store them) must equal the JAX package's for the same knots:
live on the pendulum and mini_cheetah, and from a golden on a model with a
convex hull (``scripts/make_torch_goldens.py scene``:
goldens/torch_scene_convex.npz).  The HTML template is the JAX package's
text.  Then the checks of ``tests/test_playback.py`` and
``tests/test_liveview.py``, on the port's modules.
"""
import base64
import hashlib
import json
import os
import re
import socket

import numpy as np
import pytest
import torch

from idto_tpu_torch.examples.registry import load_example
from idto_tpu_torch.models.model import GeomType, JointType, ModelBuilder
from idto_tpu_torch.utils import liveview, playback

from tests import test_liveview as jlive

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "torch_scene_convex.npz")


def _knots(q_guess, seed):
    """The guess with 0.1 N(0, 1) noise on every coordinate from a seed."""
    q = np.asarray(q_guess, dtype=np.float64)
    return q + 0.1 * np.random.default_rng(seed).standard_normal(q.shape)


def convex_scene_builder(builder_cls, joint, geom):
    """A floating body carrying a hull (off-centre vertices, a posed
    geometry frame) and a sphere, a world box and a halfspace; built with
    either package's ModelBuilder and enums."""
    rng = np.random.default_rng(11)
    verts = rng.normal(size=(12, 3)) * [0.2, 0.1, 0.05] + [0.05, -0.02, 0.1]
    b = builder_cls()
    b.add_link("body", "world", joint.FLOATING, mass=1.0,
               inertia=np.eye(3) * 1e-2)
    c, s = np.cos(0.4), np.sin(0.4)
    b.add_geometry("body", geom.CONVEX, verts=verts, name="hull",
                   R=np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]),
                   p=(0.1, 0.0, -0.05))
    b.add_geometry("body", geom.SPHERE, [0.05], p=(0.0, 0.2, 0.0),
                   name="knob")
    b.add_geometry("world", geom.BOX, [1.0, 1.0, 0.1], p=(0, 0, -0.1),
                   name="table")
    b.add_geometry("world", geom.HALFSPACE, name="ground")
    return b


def convex_scene_knots():
    rng = np.random.default_rng(12)
    quat = rng.standard_normal((5, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return np.concatenate([quat, rng.uniform(-0.5, 0.5, (5, 3))], axis=1)


@pytest.mark.parametrize("name", ["pendulum", "mini_cheetah"])
def test_scene_matches_jax(name):
    from idto_tpu.examples.registry import load_example as jax_load_example
    from idto_tpu.utils.playback import trajectory_scene_data as jax_scene

    jm, _, jprob, _, jqg = jax_load_example(name)
    model, _, prob, _, q_guess = load_example(name, device="cpu")
    qs = _knots(jqg, 5)
    assert playback.trajectory_scene_data(model, qs, prob.dt) == jax_scene(
        jm, qs, jprob.dt)
    # A tensor trajectory gives the same scene.
    assert playback.trajectory_scene_data(
        model, torch.as_tensor(qs), prob.dt) == jax_scene(jm, qs, jprob.dt)


def test_convex_scene_matches_jax_golden():
    ref = np.load(_GOLDEN)
    qs = convex_scene_knots()
    assert np.array_equal(ref["qs"], qs)
    model = convex_scene_builder(ModelBuilder, JointType,
                                 GeomType).finalize(device="cpu")
    scene = playback.trajectory_scene_data(model, qs, 0.05)
    assert json.dumps(scene) == str(ref["scene"])
    assert scene["geoms"][0]["type"] == "box"  # the hull's bounding box


def test_template_is_the_jax_text(tmp_path):
    from idto_tpu.utils import playback as jax_playback

    assert playback._HTML_TEMPLATE == jax_playback._HTML_TEMPLATE
    model, _, prob, _, q_guess = load_example("pendulum", device="cpu")
    out = playback.export_html(model, q_guess, prob.dt,
                               str(tmp_path / "p.html"), title="pendulum")
    scene = playback.trajectory_scene_data(model, q_guess, prob.dt)
    want = jax_playback._HTML_TEMPLATE.replace("__TITLE__", "pendulum") \
        .replace("__SCENE_JSON__", json.dumps(scene))
    assert open(out).read() == want


# -- the checks of tests/test_playback.py ------------------------------------


def _spinner():
    model, _, prob, _, q_guess = load_example("spinner", test_mode=True,
                                              device="cpu")
    return model, prob, q_guess


def test_scene_data_shapes_and_unit_quats():
    model, prob, q_guess = _spinner()
    scene = playback.trajectory_scene_data(model, q_guess, prob.dt)
    ng = model.geoms.num_geoms
    frames = np.asarray(scene["frames"])
    assert frames.shape == (prob.num_steps + 1, ng, 7)
    np.testing.assert_allclose(np.linalg.norm(frames[..., :4], axis=-1),
                               1.0, atol=1e-5)
    assert len(scene["geoms"]) == ng and scene["dt"] == prob.dt
    assert {g["type"] for g in scene["geoms"]} <= {
        "sphere", "box", "capsule", "cylinder", "halfspace"}


def test_export_html_self_contained(tmp_path):
    model, prob, q_guess = _spinner()
    out = playback.export_html(model, q_guess, prob.dt,
                               str(tmp_path / "out.html"), title="spinner")
    html = open(out).read()
    assert "http://" not in html and "https://" not in html
    assert "<script src" not in html
    m = re.search(r"const SCENE = (\{.*?\});\n", html, re.S)
    assert m, "embedded scene JSON not found"
    scene = json.loads(m.group(1))
    assert len(scene["frames"]) == prob.num_steps + 1
    assert len(scene["geoms"]) == model.geoms.num_geoms


def test_world_fixed_geoms_do_not_move():
    model, prob, q_guess = _spinner()
    scene = playback.trajectory_scene_data(model, q_guess, prob.dt)
    frames = np.asarray(scene["frames"])
    for i, g in enumerate(scene["geoms"]):
        if g["body"] < 0:
            np.testing.assert_array_equal(frames[:, i], frames[0:1, i])


# -- the checks of tests/test_liveview.py -------------------------------------


def _make_viewer():
    model, _, prob, _, q_guess = load_example("pendulum", device="cpu")
    return (liveview.LiveViewer(model, dt=float(prob.dt), port=0), model,
            q_guess.numpy())


def test_http_serves_viewer_page():
    viewer, model, _ = _make_viewer()
    try:
        s = socket.create_connection(("127.0.0.1", viewer.port), timeout=5)
        s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        text = data.decode("utf-8", errors="ignore")
        assert "200 OK" in text
        assert "WebSocket" in text and "SCENE" in text
        s.close()
    finally:
        viewer.close()


def test_websocket_stream_delivers_published_trajectories():
    viewer, model, q_guess = _make_viewer()
    try:
        s = socket.create_connection(("127.0.0.1", viewer.port), timeout=5)
        key = base64.b64encode(b"0123456789abcdef").decode()
        r, resp = jlive._ws_handshake(s, key)
        expect = base64.b64encode(
            hashlib.sha1((key + liveview._WS_GUID).encode()).digest()
        ).decode()
        assert expect in resp.decode("latin1")
        T = 5
        qs = np.tile(q_guess[:1], (T + 1, 1))
        qs[:, 0] = np.linspace(0.0, 1.0, T + 1)
        viewer.publish(qs)
        msg = json.loads(jlive._read_ws_text(r))
        assert len(msg["frames"]) == T + 1 and msg["dt"] > 0
        assert len(msg["frames"][0]) == model.geoms.num_geoms
        viewer.publish(torch.as_tensor(qs[:T]))
        assert len(json.loads(jlive._read_ws_text(r))["frames"]) == T
        s.close()
    finally:
        viewer.close()


def test_late_joiner_receives_last_published():
    viewer, model, q_guess = _make_viewer()
    try:
        viewer.publish(np.tile(q_guess[:1], (3, 1)))
        s = socket.create_connection(("127.0.0.1", viewer.port), timeout=5)
        key = base64.b64encode(b"fedcba9876543210").decode()
        r, _ = jlive._ws_handshake(s, key)
        assert len(json.loads(jlive._read_ws_text(r))["frames"]) == 3
        s.close()
    finally:
        viewer.close()


def test_serves_localhost_only():
    model, _, prob, _, _ = load_example("pendulum", device="cpu")
    with pytest.raises(ValueError, match="localhost"):
        liveview.LiveViewer(model, dt=float(prob.dt), port=0,
                            host="0.0.0.0")


def test_run_playback_writes_the_jax_scene(tmp_path, capsys, monkeypatch):
    """``examples/run.py --playback``: the scene of the solved trajectory
    (the ``--test`` solve cut to two iterations), the one the JAX package's
    export gives for the same knots."""
    import dataclasses

    from idto_tpu.examples.registry import load_example as jax_load_example
    from idto_tpu.utils.playback import trajectory_scene_data as jax_scene
    from idto_tpu_torch.examples import run as cli
    from idto_tpu_torch.examples.config import ExampleConfig
    from idto_tpu_torch.optimizer.solver import solve

    test_mode = ExampleConfig.apply_test_mode
    monkeypatch.setattr(ExampleConfig, "apply_test_mode", lambda self: (
        dataclasses.replace(test_mode(self), max_iters=2)))

    out = tmp_path / "pendulum.html"
    assert cli.main(["pendulum", "--test", "--device", "cpu", "--playback",
                     str(out)]) == 0
    assert f"playback written to {out}" in capsys.readouterr().out
    scene = json.loads(re.search(r"const SCENE = (\{.*?\});\n",
                                 out.read_text(), re.S).group(1))
    model, _, prob, params, q_guess = load_example("pendulum",
                                                   test_mode=True,
                                                   device="cpu")
    sol = solve(model, prob, params, q_guess)[0]
    jm, _, jprob, _, _ = jax_load_example("pendulum", test_mode=True)
    assert scene == json.loads(json.dumps(jax_scene(jm, sol.q.numpy(),
                                                    jprob.dt)))
