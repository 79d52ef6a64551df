"""Scene/asset I/O tests: parse every corpus scene XML and check counts,
material tables, lights and transforms (SURVEY.md §4a golden corpus)."""

import os

import numpy as np
import pytest

from torrey.io.obj import parse_obj
from torrey.io.ply import parse_ply
from torrey.io.xml_scene import parse_scene
from torrey.models.blob import blob_mesh
from torrey.models.ir import (
    ParsedDiffuseAreaLight, ParsedPointLight, ParsedSphere,
    ParsedTriangleMesh)
from torrey.models.scenepack import pack_scene
from torrey.utils import math3d as m3

ALL_SCENES = [
    "spheres/scene0.xml",
    "spheres/scene0_spherical_light.xml",
    "spheres/scene1.xml",
    "spheres/scene1_spherical_light.xml",
    "spheres/scene1_spherical_light_phong.xml",
    "spheres/scene2.xml",
    "spheres/scene3.xml",
    "spheres/scene4.xml",
    "cbox/cbox.xml",
    "teapot/teapot_constant.xml",
    "bunny/bunny.xml",
    "triangles/single_triangle.xml",
    "triangles/tetrahedron.xml",
    "aabb_test/aabb_test.xml",
]


def _scene_path(scenes_dir, rel):
    return os.path.join(scenes_dir, rel)


@pytest.mark.parametrize("rel", ALL_SCENES)
def test_parse_and_pack_all_scenes(scenes_dir, rel):
    path = _scene_path(scenes_dir, rel)
    parsed = parse_scene(path)
    assert parsed.camera.width > 0 and parsed.camera.height > 0
    pack = pack_scene(parsed)
    assert pack.num_prims >= 1
    assert pack.bvh_nodes.shape == (2 * pack.num_prims - 1, 16)
    assert not np.any(np.isnan(pack.vert_pos))
    assert not np.any(np.isnan(pack.bvh_nodes[:, :9]))


def test_scene1_contents(scenes_dir):
    parsed = parse_scene(_scene_path(scenes_dir, "spheres/scene1.xml"))
    assert parsed.camera.width == 640 and parsed.camera.height == 480
    assert parsed.camera.vfov == pytest.approx(45.0)
    assert parsed.samples_per_pixel == 500
    assert len(parsed.shapes) == 4
    assert all(isinstance(s, ParsedSphere) for s in parsed.shapes)
    assert len([l for l in parsed.lights if isinstance(l, ParsedPointLight)]) == 3
    # 4 bsdfs: diffuse yellow/red, mirror purple/cyan
    assert len(parsed.materials) == 4
    pack = pack_scene(parsed)
    assert pack.num_spheres == 4
    np.testing.assert_allclose(pack.background, [0.5, 0.5, 0.5])
    np.testing.assert_allclose(pack.mat_color[0], [0.8, 0.8, 0.2])
    # big floor sphere
    np.testing.assert_allclose(pack.sph_center[0], [0, -100.5, -3])
    assert pack.sph_radius[0] == pytest.approx(100.0)


def test_cbox_contents(scenes_dir):
    parsed = parse_scene(_scene_path(scenes_dir, "cbox/cbox.xml"))
    assert parsed.camera.width == 512
    # 8 OBJ shapes, the first with an area emitter
    meshes = [s for s in parsed.shapes if isinstance(s, ParsedTriangleMesh)]
    assert len(meshes) == 8
    area = [l for l in parsed.lights if isinstance(l, ParsedDiffuseAreaLight)]
    assert len(area) == 1
    assert area[0].shape_id == 0
    np.testing.assert_allclose(area[0].radiance, [5.157, 2.7272, 0.69076])
    pack = pack_scene(parsed)
    # luminaire triangles carry the emission
    F_lum = meshes[0].indices.shape[0]
    emissive = np.any(pack.prim_emission > 0, axis=-1)
    assert emissive.sum() == F_lum
    # camera fov conversion: fovAxis=y means no conversion
    assert parsed.camera.vfov == pytest.approx(39.3077)


def test_spherical_light_scene(scenes_dir):
    parsed = parse_scene(
        _scene_path(scenes_dir, "spheres/scene1_spherical_light.xml"))
    pack = pack_scene(parsed)
    emissive = np.any(pack.prim_emission > 0, axis=-1)
    assert emissive.sum() == 1  # one emissive sphere


def test_rectangle_expansion(scenes_dir):
    # teapot scene has a rectangle -> 2-triangle mesh with a big transform
    parsed = parse_scene(
        _scene_path(scenes_dir, "teapot/teapot_constant.xml"))
    rect = parsed.shapes[-1]
    assert isinstance(rect, ParsedTriangleMesh)
    assert rect.indices.shape == (2, 3)
    # rotate 90 about x then scale 2000: plane ends up at y ~ 0 spanning xz
    assert np.max(np.abs(rect.positions[:, 1])) < 1e-3
    assert np.max(np.abs(rect.positions[:, 0])) == pytest.approx(2000, rel=1e-5)
    # normal should point along -+y after rotation, unit length
    assert np.allclose(np.abs(rect.normals[0]), [0, 1, 0], atol=1e-6)


def test_obj_loader_teapot(tmp_path):
    """The teapot stand-in (a seeded mesh, models/blob.py) written as OBJ
    and read back: same triangles, indices in range."""
    mesh = blob_mesh(11, 6320)
    path = tmp_path / "teapot.obj"
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.positions]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in mesh.indices]
    path.write_text("\n".join(lines) + "\n")
    got = parse_obj(str(path))
    assert got.indices.shape == (6320, 3)
    assert np.all(got.indices >= 0)
    assert np.all(got.indices < got.positions.shape[0])
    np.testing.assert_allclose(got.positions[got.indices],
                               mesh.positions[mesh.indices], atol=1e-6)


def test_obj_loader_quads_and_negative_indices(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("""
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f -4 -3 -2 -1
""")
    mesh = parse_obj(str(obj))
    assert mesh.indices.shape == (2, 3)  # quad -> 2 tris
    np.testing.assert_array_equal(mesh.indices, [[0, 1, 2], [0, 2, 3]])


def test_obj_loader_corner_dedup(tmp_path):
    obj = tmp_path / "c.obj"
    obj.write_text("""
v 0 0 0
v 1 0 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1
f 1//1 3//1 2//1
""")
    mesh = parse_obj(str(obj))
    assert mesh.positions.shape[0] == 3  # corners deduped
    assert mesh.normals is not None
    np.testing.assert_allclose(mesh.normals, [[0, 0, 1]] * 3)


def test_obj_ngon_rejected(tmp_path):
    obj = tmp_path / "n.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 2 0\nf 1 2 3 4 5\n")
    with pytest.raises(Exception):
        parse_obj(str(obj))


def test_ply_loader_bunny(tmp_path):
    """The bunny stand-in at the reference's 144,046 triangles, written as
    binary little-endian PLY with normals and uvs and read back."""
    mesh = blob_mesh(7, 144046)
    V = mesh.positions.shape[0]
    verts = np.concatenate([mesh.positions, mesh.normals, mesh.uvs],
                           axis=1).astype("<f4")
    faces = np.zeros(144046, [("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, mesh.indices
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {V}\n"
              + "".join(f"property float {p}\n"
                        for p in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
              + "element face 144046\n"
              "property list uchar int vertex_indices\nend_header\n")
    path = tmp_path / "bunny.ply"
    path.write_bytes(header.encode() + verts.tobytes() + faces.tobytes())
    got = parse_ply(str(path))
    assert got.indices.shape == (144046, 3)
    assert got.positions.shape == (V, 3)
    assert got.normals is not None and got.normals.shape == (V, 3)
    assert np.allclose(np.linalg.norm(got.normals, axis=-1), 1.0, atol=1e-3)
    assert got.uvs is not None
    np.testing.assert_array_equal(got.indices, mesh.indices)


def test_ply_ascii_roundtrip(tmp_path):
    ply = tmp_path / "t.ply"
    ply.write_text("""ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
""")
    mesh = parse_ply(str(ply))
    assert mesh.positions.shape == (3, 3)
    np.testing.assert_array_equal(mesh.indices, [[0, 1, 2]])


def test_ply_transform_applied(tmp_path):
    ply = tmp_path / "t.ply"
    ply.write_text("""ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
""")
    mesh = parse_ply(str(ply), m3.translate((5, 0, 0)))
    np.testing.assert_allclose(mesh.positions[:, 0], [5, 6, 5])


def test_default_var_substitution(tmp_path):
    xml = tmp_path / "s.xml"
    xml.write_text("""<scene version="0.6.0">
  <default name="res" value="128"/>
  <default name="col" value="0.1, 0.2, 0.3"/>
  <sensor type="perspective">
    <film type="hdrfilm">
      <integer name="width" value="$res"/>
      <integer name="height" value="$res"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="d"><rgb name="reflectance" value="$col"/></bsdf>
  <shape type="sphere"><ref id="d"/></shape>
</scene>""")
    parsed = parse_scene(str(xml))
    assert parsed.camera.width == 128
    np.testing.assert_allclose(parsed.materials[0].reflectance, [0.1, 0.2, 0.3])


def test_fov_axis_x_conversion(tmp_path):
    xml = tmp_path / "s.xml"
    xml.write_text("""<scene version="0.6.0">
  <sensor type="perspective">
    <string name="fovAxis" value="x"/>
    <float name="fov" value="90"/>
    <film type="hdrfilm">
      <integer name="width" value="200"/>
      <integer name="height" value="100"/>
    </film>
  </sensor>
  <shape type="sphere"/>
</scene>""")
    parsed = parse_scene(str(xml))
    expect = np.degrees(2 * np.arctan(np.tan(np.radians(45.0)) * 100 / 200))
    assert parsed.camera.vfov == pytest.approx(expect)


def test_twosided_unwrap_and_srgb(tmp_path):
    xml = tmp_path / "s.xml"
    xml.write_text("""<scene version="0.6.0">
  <bsdf type="twosided" id="outer">
    <bsdf type="diffuse"><srgb name="reflectance" value="#ff8000"/></bsdf>
  </bsdf>
  <shape type="sphere"><ref id="outer"/></shape>
</scene>""")
    parsed = parse_scene(str(xml))
    refl = parsed.materials[0].reflectance
    expect = m3.srgb_to_rgb(np.array([255, 128, 0], float) / 255.0)
    np.testing.assert_allclose(refl, expect, atol=1e-6)
    assert parsed.shapes[0].material_id == 0
