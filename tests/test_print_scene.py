"""Scene pretty-printer (print_scene.cpp parity, SURVEY.md C12)."""

from torrey.io.print_scene import format_scene
from torrey.io.xml_scene import parse_scene


def test_format_cbox(scenes_dir):
    s = parse_scene(f"{scenes_dir}/cbox/cbox.xml")
    txt = format_scene(s)
    assert "Camera[lookfrom=(278, 273, -800)" in txt
    assert "DiffuseAreaLight[shape_id=0" in txt
    assert "materials[5]" in txt and "shapes[8]" in txt
    assert txt.count("TriangleMesh[") == 8


def test_format_spheres_and_pointlights(scenes_dir):
    s = parse_scene(f"{scenes_dir}/spheres/scene1.xml")
    txt = format_scene(s)
    assert "Sphere[" in txt and "PointLight[" in txt


def test_cli(scenes_dir, capsys):
    from torrey.io import print_scene
    assert print_scene.main([f"{scenes_dir}/triangles/tetrahedron.xml"]) == 0
    out = capsys.readouterr().out
    assert "Scene[" in out and "TriangleMesh[" in out
