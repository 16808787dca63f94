"""The port's mesh loading, primitive fitting, convex hulls, the URDF
``<mesh>`` branch and the SDF parser against the JAX package.

Both sides are numpy code on the same files, written under ``tmp_path``:
vertices, fits and hulls must be equal to the last bit, and a model parsed
by the port must equal ``convert.model`` of the JAX package's parse of the
same text (topology equal, every tensor equal, hull vertices included).
"""
import itertools
import struct

import numpy as np
import pytest
import torch

from idto_tpu.models import mesh as jmesh
from idto_tpu.models import sdf as jsdf
from idto_tpu.models import urdf as jurdf
from idto_tpu_torch import convert
from idto_tpu_torch.models import mesh as tmesh
from idto_tpu_torch.models import sdf as tsdf
from idto_tpu_torch.models import urdf as turdf
from idto_tpu_torch.models.model import GeomType, ModelBuilder, JointType

from tests.test_torch_model import _assert_same

# One intra-op thread: several test workers share the cores.
torch.set_num_threads(1)


def _cloud(seed, n=300, scale=(0.2, 0.05, 0.05)):
    return np.random.default_rng(seed).normal(size=(n, 3)) * scale


def _xyz(v):
    return " ".join(repr(float(c)) for c in v)


def _write_obj(path, verts):
    path.write_text("# cloud\n" + "\n".join(
        "v " + _xyz(v) for v in verts) + "\nf 1 2 3\n")


def _write_binary_stl(path, verts):
    tris = verts[: 3 * (len(verts) // 3)].reshape(-1, 3, 3)
    data = b"\0" * 80 + struct.pack("<I", len(tris))
    for tri in tris:
        data += struct.pack("<3f", 0, 0, 1)
        for v in tri:
            data += struct.pack("<3f", *v)
        data += struct.pack("<H", 0)
    path.write_bytes(data)


def _write_ascii_stl(path, verts):
    tris = verts[: 3 * (len(verts) // 3)].reshape(-1, 3, 3)
    lines = ["solid t"]
    for tri in tris:
        lines += [" facet normal 0 0 1", "  outer loop"]
        lines += ["   vertex " + _xyz(v) for v in tri]
        lines += ["  endloop", " endfacet"]
    path.write_text("\n".join(lines + ["endsolid t"]) + "\n")


def _equal(a, b):
    """Equal nested results of the two packages' numpy functions (GeomType
    members compare by value)."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("fmt", ["obj", "binary_stl", "ascii_stl"])
def test_loaders_match_jax(tmp_path, fmt):
    verts = _cloud(0, n=60)
    name = "m.obj" if fmt == "obj" else "m.stl"
    path = tmp_path / name
    {"obj": _write_obj, "binary_stl": _write_binary_stl,
     "ascii_stl": _write_ascii_stl}[fmt](path, verts)
    got = tmesh.load_mesh_vertices(path)
    np.testing.assert_array_equal(got, jmesh.load_mesh_vertices(path))
    assert got.shape == (60, 3)
    with pytest.raises(ValueError):
        tmesh.load_mesh_vertices(tmp_path / "m.ply")


def test_fits_and_hulls_match_jax():
    for seed, scale in ((1, (0.2, 0.05, 0.05)), (2, (0.1, 0.1, 0.1)),
                        (3, (0.3, 0.2, 0.02))):
        v = _cloud(seed, scale=scale)
        _equal(tmesh.fit_sphere(v), jmesh.fit_sphere(v))
        _equal(tmesh.fit_box(v), jmesh.fit_box(v))
        _equal(tmesh.fit_capsule(v), jmesh.fit_capsule(v))
        for kind in ("auto", "sphere", "box", "capsule"):
            t, j = tmesh.approximate_mesh(v, kind), \
                jmesh.approximate_mesh(v, kind)
            assert int(t[0]) == int(j[0])
            _equal(list(t[1:]), list(j[1:]))
        for max_verts in (8, 16, 64):  # 8 and 16 decimate
            _equal(tmesh.convex_hull_vertices(v, max_verts),
                   jmesh.convex_hull_vertices(v, max_verts))
    _equal(tmesh._fibonacci_directions(256),
           jmesh._fibonacci_directions(256))


@pytest.mark.parametrize("mode", ["convex", "primitive", "sphere", "box",
                                  "capsule", None])
def test_mesh_to_collision_matches_jax(tmp_path, monkeypatch, mode):
    path = tmp_path / "leg.obj"
    _write_obj(path, _cloud(4))
    scale = np.array([1.0, 2.0, 0.5])
    if mode is None:  # the environment variable decides
        monkeypatch.setenv("IDTO_MESH_COLLISION", "box")
    t = tmesh.mesh_to_collision(path, scale=scale, mode=mode)
    j = jmesh.mesh_to_collision(path, scale=scale, mode=mode)
    assert int(t[0]) == int(j[0])
    _equal(list(t[1:]), list(j[1:]))
    if mode is None:
        assert t[0] == GeomType.BOX
    with pytest.raises(ValueError):
        tmesh.mesh_to_collision(path, mode="voxels")


_MESH_URDF = """<robot name="r">
  <link name="base">
    <inertial><mass value="1"/>
      <inertia ixx="1e-3" iyy="1e-3" izz="1e-3" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision name="hull">
      <origin xyz="0 0 0.1" rpy="0.1 0.2 0.3"/>
      <geometry><mesh filename="pad.obj" scale="1 2 0.5"/></geometry>
    </collision>
    <collision name="absent">
      <geometry><mesh filename="missing.obj"/></geometry>
    </collision>
    <collision name="nameless"><geometry><mesh/></geometry></collision>
  </link>
  <link name="leg">
    <inertial><mass value="0.5"/>
      <inertia ixx="1e-3" iyy="1e-3" izz="1e-3" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision name="leg_c">
      <geometry><mesh filename="meshes/leg.stl"/></geometry>
    </collision>
  </link>
  <joint name="hip" type="revolute">
    <parent link="base"/><child link="leg"/>
    <origin xyz="0.2 0 0"/><axis xyz="0 1 0"/>
  </joint>
  <link name="ground_pad">
    <collision name="ground_c">
      <geometry><box size="2 2 0.1"/></geometry>
    </collision>
  </link>
  <joint name="weld" type="fixed">
    <parent link="world"/><child link="ground_pad"/>
  </joint>
</robot>"""


def _mesh_files(tmp_path):
    corners = np.array([s * np.array([0.1, 0.08, 0.02])
                        for s in itertools.product([-1.0, 1.0], repeat=3)])
    _write_obj(tmp_path / "pad.obj", corners)
    (tmp_path / "meshes").mkdir()
    _write_binary_stl(tmp_path / "meshes" / "leg.stl", _cloud(5, n=90))


@pytest.mark.parametrize("mode", ["convex", "primitive"])
def test_urdf_mesh_matches_jax(tmp_path, monkeypatch, mode):
    """``<mesh>`` with scale and an origin, a missing file and a mesh
    without filename (no geometry), a path in a subdirectory: the port's
    model equals the converted JAX one, with the hulls' padded vertices."""
    monkeypatch.setenv("IDTO_MESH_COLLISION", mode)
    _mesh_files(tmp_path)
    path = tmp_path / "r.urdf"
    path.write_text(_MESH_URDF)
    jm = jurdf.parse_urdf_file(path).finalize()
    tm = turdf.parse_urdf_file(path).finalize(device="cpu")
    _assert_same(tm, convert.model(jm, device="cpu"), "model")
    assert tm.geoms.names == ("hull", "leg_c", "ground_c")
    if mode == "convex":
        assert tm.geoms.types[:2] == (int(GeomType.CONVEX),) * 2
        assert tm.geoms.verts.shape[0] == 3
        # The pad's 8 hull vertices are padded by repeating the first.
        pad = tm.geoms.verts[0]
        assert torch.equal(pad[8:], pad[:1].expand(pad.shape[0] - 8, 3))
    else:
        assert tm.geoms.verts is None
    # From a string, with no directory to resolve meshes in: no geometry.
    tm2 = turdf.parse_urdf_string(_MESH_URDF).finalize(device="cpu")
    assert tm2.geoms.names == ("ground_c",)


def test_convex_builder_conventions():
    """``add_geometry(verts=)`` and the hull in the params slot give the
    same model; a CONVEX geometry without a (m, 3) vertex set raises."""
    verts = _cloud(6, n=12)
    models = []
    for how in ("verts", "params"):
        b = ModelBuilder()
        b.add_link("pad", "world", JointType.FLOATING, mass=1.0,
                   inertia=np.eye(3) * 1e-3)
        b.add_geometry("pad", GeomType.SPHERE, [0.1], name="ball")
        kw = {"verts": verts} if how == "verts" else {"params": verts}
        b.add_geometry("pad", GeomType.CONVEX, name="hull", **kw)
        b.add_geometry("world", GeomType.HALFSPACE, name="ground")
        models.append(b.finalize(device="cpu"))
    _assert_same(models[0], models[1], "model")
    g = models[0].geoms
    assert g.verts.shape == (3, 12, 3)
    assert torch.equal(g.verts[1], torch.as_tensor(verts))
    assert not g.verts[0].any() and not g.verts[2].any()
    with pytest.raises(ValueError):
        ModelBuilder().add_geometry("world", GeomType.CONVEX, [1.0, 2.0])


# -- the SDF parser: the cases of tests/test_sdf.py and a mesh ---------------

from tests import test_sdf as sdf_cases  # noqa: E402

PENDULUM_SDF, PENDULUM_URDF = sdf_cases.PENDULUM_SDF, sdf_cases.PENDULUM_URDF
_DECOUPLED_SDF = sdf_cases.TestJointFrameDecoupling.SDF
_FREE_BODY_SDF = sdf_cases.TestFreeBody.SDF

_MESH_SDF = """<?xml version="1.0"?>
<sdf version="1.7">
  <model name="pad">
    <pose>0 0 0.5 0 0 0.3</pose>
    <link name="pad">
      <pose>0.1 0 0 0 0 0</pose>
      <inertial><mass>1.0</mass>
        <inertia><ixx>1e-3</ixx><iyy>1e-3</iyy><izz>1e-3</izz>
                 <ixy>0</ixy><ixz>0</ixz><iyz>0</iyz></inertia>
      </inertial>
      <collision name="pad_hull">
        <pose>0 0 -0.01 0 0 0</pose>
        <geometry><mesh><uri>pad.obj</uri><scale>1 1 2</scale></mesh>
        </geometry>
      </collision>
      <collision name="pad_missing">
        <geometry><mesh><uri>missing.obj</uri></mesh></geometry>
      </collision>
    </link>
    <link name="flap">
      <pose relative_to="pad">0.2 0 0 0 0 0</pose>
      <inertial><mass>0.2</mass></inertial>
      <collision name="flap_c">
        <geometry><capsule><radius>0.01</radius><length>0.1</length>
        </capsule></geometry>
      </collision>
    </link>
    <joint name="hinge" type="continuous">
      <parent>pad</parent><child>flap</child>
      <axis><xyz>0 1 0</xyz><limit><effort>0</effort></limit></axis>
    </joint>
  </model>
</sdf>
"""

_SDF_CASES = {
    "pendulum": (PENDULUM_SDF, {}),
    "decoupled": (_DECOUPLED_SDF, {"floating_base": False}),
    "model_frame_axis": (_DECOUPLED_SDF.replace(
        "<pose>-0.1 0 0 0 0 0</pose>",
        "<pose>-0.1 0 0 0 0 1.5707963267948966</pose>"),
        {"floating_base": False}),
    "floating_root": (_FREE_BODY_SDF, {}),
    "welded_root": (_FREE_BODY_SDF, {"floating_base": False}),
    "mesh": (_MESH_SDF, {}),
}


@pytest.mark.parametrize("case", sorted(_SDF_CASES))
def test_sdf_matches_jax(tmp_path, monkeypatch, case):
    monkeypatch.delenv("IDTO_MESH_COLLISION", raising=False)
    _mesh_files(tmp_path)
    text, kw = _SDF_CASES[case]
    path = tmp_path / "m.sdf"
    path.write_text(text)
    jm = jsdf.parse_model_file(path, **kw).finalize()
    tm = tsdf.parse_model_file(path, **kw).finalize(device="cpu")
    _assert_same(tm, convert.model(jm, device="cpu"), case)
    if case == "mesh":
        assert tm.geoms.names == ("pad_hull", "flap_c")
        assert tm.geoms.types[0] == int(GeomType.CONVEX)
        assert tm.nu == 0  # effort 0: not actuated
    # The string parser agrees where no mesh file needs resolving.
    if case != "mesh":
        _assert_same(tsdf.parse_sdf_string(text, **kw).finalize(device="cpu"),
                     tm, case)


def test_parse_model_file_dispatches_by_extension(tmp_path):
    (tmp_path / "p.sdf").write_text(PENDULUM_SDF)
    (tmp_path / "p.urdf").write_text(PENDULUM_URDF)
    ms = tsdf.parse_model_file(tmp_path / "p.sdf").finalize(device="cpu")
    mu = tsdf.parse_model_file(tmp_path / "p.urdf").finalize(device="cpu")
    assert ms.nq == mu.nq == 1 and ms.nu == mu.nu == 1
    assert torch.equal(ms.geoms.p, mu.geoms.p)
    with pytest.raises(ValueError):
        tsdf.parse_sdf_string("<sdf version='1.7'></sdf>")
