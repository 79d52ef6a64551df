"""Next-event estimation for point lights (beyond-reference capability —
the reference parses point lights but its GPU integrator never samples
them, SURVEY.md §3.5)."""

import textwrap

import numpy as np
import pytest

import jax.numpy as jnp

from torrey.models.device_scene import DeviceScene
from torrey.models.scenepack import load_scene
from torrey.ops import integrator
from torrey.ops.camera import Camera, camera_ray_data

W, H = 64, 48


def _write_scene(tmp_path, body):
    xml = textwrap.dedent(f"""\
        <scene version="0.6.0">
          <sensor type="perspective">
            <float name="fov" value="45"/>
            <transform name="toWorld">
              <lookat origin="0, 3, 0" target="0, 0, 0" up="0, 0, 1"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="{W}"/>
              <integer name="height" value="{H}"/>
            </film>
          </sensor>
          {body}
        </scene>
        """)
    p = tmp_path / "scene.xml"
    p.write_text(xml)
    return str(p)


def test_nee_matches_analytic_inverse_square(tmp_path):
    # unit diffuse sphere at origin, point light straight above the pole at
    # height h: the pole's direct radiance is albedo/pi * I / (h-1)^2
    # (cos = 1).  Camera looks straight down at the pole; background black.
    albedo, h, inten = 0.6, 4.0, 10.0
    scene = _write_scene(tmp_path, f"""
          <background><rgb name="radiance" value="0, 0, 0"/></background>
          <bsdf type="diffuse" id="m">
            <rgb name="reflectance" value="{albedo}, {albedo}, {albedo}"/>
          </bsdf>
          <emitter type="point">
            <point name="position" x="0" y="{h}" z="0"/>
            <rgb name="intensity" value="{inten}, {inten}, {inten}"/>
          </emitter>
          <shape type="sphere">
            <point name="center" x="0" y="0" z="0"/>
            <float name="radius" value="1"/>
            <ref id="m"/>
          </shape>
    """)
    pack, parsed = load_scene(scene)
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    img = np.asarray(integrator.render_samples(
        ds, cd, W, H, 0, 1, max_depth=1, nee=True))
    expect = albedo / np.pi * inten / (h - 1.0) ** 2
    center = img[H // 2, W // 2]
    np.testing.assert_allclose(center, expect, rtol=2e-2)
    # without NEE (reference behavior) the same config is black
    img0 = np.asarray(integrator.render_samples(
        ds, cd, W, H, 0, 1, max_depth=1, nee=False))
    assert img0[H // 2, W // 2].max() == 0.0


def test_nee_shadow_rays(tmp_path):
    # light off to the upper right; the occluder sits on the light-sphere
    # axis OUTSIDE the camera frustum (camera looks straight down with a
    # 22.5 deg half-fov; the occluder is 48 deg off-axis), so the two
    # renders differ ONLY by the shadow it casts on the big sphere
    occluded_body = """
          <background><rgb name="radiance" value="0, 0, 0"/></background>
          <bsdf type="diffuse" id="m">
            <rgb name="reflectance" value="0.6, 0.6, 0.6"/>
          </bsdf>
          <emitter type="point">
            <point name="position" x="2.5" y="2.5" z="0"/>
            <rgb name="intensity" value="10, 10, 10"/>
          </emitter>
          <shape type="sphere">
            <point name="center" x="0" y="0" z="0"/>
            <float name="radius" value="1"/>
            <ref id="m"/>
          </shape>
          <shape type="sphere">
            <point name="center" x="1.4" y="1.75" z="0"/>
            <float name="radius" value="0.2"/>
            <ref id="m"/>
          </shape>
    """
    pack, parsed = load_scene(_write_scene(tmp_path, occluded_body))
    ds = DeviceScene.from_pack(pack)

    # direct shadow-ray checks: the shadow patch near (0.25, 0.97, 0) is
    # blocked; the pole's own path to the light is clear
    from torrey.ops.trace import trace_occluded
    from torrey.ops.vec import Vec3
    ones = jnp.ones((1, 1), jnp.float32)

    def occluded_from(p):
        p = np.asarray(p, np.float64)
        dvec = np.array([2.5, 2.5, 0.0]) - p
        dist = np.linalg.norm(dvec)
        dvec /= dist
        sp = Vec3(*(float(c) * ones for c in p))
        sd = Vec3(*(float(c) * ones for c in dvec))
        occ = trace_occluded(jnp.asarray(ds.bvh_nodes), sp, sd,
                             1e-3, dist * (1 - 1e-3))
        return bool(np.asarray(occ)[0, 0])

    assert occluded_from([0.249, 0.966, 0.0])       # in the umbra
    # light-facing point whose segment to the light passes 0.48 from the
    # occluder center (radius 0.2) — clearly lit
    assert not occluded_from([0.966, 0.259, 0.0])

    # end-to-end: with the occluder teleported far away, every pixel is at
    # least as bright, and the shadow patch is visibly brighter
    clear_body = occluded_body.replace(
        '<point name="center" x="1.4" y="1.75" z="0"/>',
        '<point name="center" x="50" y="1.75" z="0"/>')
    pack2, _ = load_scene(_write_scene(tmp_path, clear_body))
    ds2 = DeviceScene.from_pack(pack2)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    with_occ = np.asarray(integrator.render_samples(
        ds, cd, W, H, 0, 1, max_depth=1, nee=True))
    no_occ = np.asarray(integrator.render_samples(
        ds2, cd, W, H, 0, 1, max_depth=1, nee=True))
    assert (with_occ <= no_occ + 1e-5).all()
    assert (no_occ - with_occ).max() > 0.05       # a visible shadow


def test_nee_brightens_pointlight_scene(scenes_dir):
    pack, parsed = load_scene(f"{scenes_dir}/spheres/scene1.xml")
    assert pack.light_pos.shape[0] > 0
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    off = np.asarray(integrator.render_samples(ds, cd, W, H, 0, 1,
                                               max_depth=4, nee=False))
    on = np.asarray(integrator.render_samples(ds, cd, W, H, 0, 1,
                                              max_depth=4, nee=True))
    assert (on >= off - 1e-6).all()       # NEE only adds light
    assert on.mean() > off.mean() + 1e-3  # and it does add light


def test_nee_megakernel_matches_xla(tmp_path):
    """Point-light NEE on the megakernel (brute-force shadow rays over the
    primitive table) agrees with the XLA oracle's _direct_point_lights — same PCG
    streams (NEE draws no RNG), so only fp ordering differs."""
    from torrey.ops.megakernel import render_samples_pallas

    body = """
          <background><rgb name="radiance" value="0.1, 0.1, 0.1"/></background>
          <bsdf type="diffuse" id="m">
            <rgb name="reflectance" value="0.6, 0.5, 0.4"/>
          </bsdf>
          <emitter type="point">
            <point name="position" x="2.5" y="2.5" z="0"/>
            <rgb name="intensity" value="10, 10, 10"/>
          </emitter>
          <shape type="sphere">
            <point name="center" x="0" y="0" z="0"/>
            <float name="radius" value="1"/>
            <ref id="m"/>
          </shape>
          <shape type="sphere">
            <point name="center" x="1.4" y="1.75" z="0"/>
            <float name="radius" value="0.2"/>
            <ref id="m"/>
          </shape>
    """
    pack, parsed = load_scene(_write_scene(tmp_path, body))
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    ref = np.asarray(integrator.render_samples(
        ds, cd, W, H, 0, 2, max_depth=3, nee=True))
    got = np.asarray(render_samples_pallas(
        ds, cd, W, H, 0, 2, max_depth=3, interpret=True, nee=True))
    assert np.abs(ref - got).mean() < 1e-4
    # and NEE actually contributes (vs the same kernel without it)
    base = np.asarray(render_samples_pallas(
        ds, cd, W, H, 0, 2, max_depth=3, interpret=True, nee=False))
    assert (got - base).max() > 0.05


def test_nee_megakernel_triangle_shadows_match_xla(tmp_path):
    """Point-light NEE on the megakernel with a triangle receiver and a
    sphere occluder: its brute-force shadow rays agree with the oracle's
    BVH any-hit query."""
    from torrey.ops.megakernel import render_samples_pallas

    body = """
          <background><rgb name="radiance" value="0.05, 0.05, 0.05"/></background>
          <bsdf type="diffuse" id="m">
            <rgb name="reflectance" value="0.6, 0.5, 0.4"/>
          </bsdf>
          <emitter type="point">
            <point name="position" x="0" y="2.5" z="1"/>
            <rgb name="intensity" value="8, 8, 8"/>
          </emitter>
          <shape type="rectangle">
            <transform name="toWorld">
              <rotate x="1" angle="-90"/>
              <scale value="3"/>
            </transform>
            <ref id="m"/>
          </shape>
          <shape type="sphere">
            <point name="center" x="0" y="0.5" z="0"/>
            <float name="radius" value="0.5"/>
            <ref id="m"/>
          </shape>
    """
    pack, parsed = load_scene(_write_scene(tmp_path, body))
    ds = DeviceScene.from_pack(pack)
    cd = jnp.asarray(camera_ray_data(Camera.from_parsed(parsed.camera), W, H))
    ref = np.asarray(integrator.render_samples(
        ds, cd, W, H, 0, 1, max_depth=3, nee=True))
    got = np.asarray(render_samples_pallas(
        ds, cd, W, H, 0, 1, max_depth=3, interpret=True, nee=True))
    bad = np.abs(ref - got) > 1e-3
    assert bad.mean() < 1e-3
    assert np.abs(ref - got).mean() < 1e-3
    base = np.asarray(render_samples_pallas(
        ds, cd, W, H, 0, 1, max_depth=3, interpret=True, nee=False))
    assert (got - base).max() > 0.02
