"""Device-resident scene in SoA layout.

``ScenePack`` (scenepack.py) is the host build product with conventional
``[N, 3]`` arrays; ``DeviceScene`` is its transposed *per-component* form:
every hot array is split into flat ``[N]`` component vectors so that
per-ray gathers produce ``[rows, 128]`` results with no minor-dim-3 layout
(see ops/vec.py).  This split replaces the reference's ``GPUScene::copyFrom``
H2D upload step (scene.h:73-142) — here "upload" is a pytree
``jax.device_put`` and replication across a mesh is a sharding annotation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import numpy as np

from .scenepack import ScenePack


@dataclass
class DeviceScene:
    # materials (differentiable leaves)
    mat_type: np.ndarray    # [M] i32
    mat_r: np.ndarray       # [M] f32 reflectance per channel
    mat_g: np.ndarray
    mat_b: np.ndarray
    mat_param: np.ndarray   # [M] f32 eta / exponent
    # spheres
    sph_x: np.ndarray       # [S]
    sph_y: np.ndarray
    sph_z: np.ndarray
    sph_rad: np.ndarray
    # triangles: p0 + edges, per component
    tri_p0x: np.ndarray     # [F]
    tri_p0y: np.ndarray
    tri_p0z: np.ndarray
    tri_e1x: np.ndarray
    tri_e1y: np.ndarray
    tri_e1z: np.ndarray
    tri_e2x: np.ndarray
    tri_e2y: np.ndarray
    tri_e2z: np.ndarray
    # triangle vertex indices (for shading attributes)
    tri_i0: np.ndarray      # [F] i32
    tri_i1: np.ndarray
    tri_i2: np.ndarray
    # vertex attribute pools, per component
    vtx_nx: np.ndarray      # [V]
    vtx_ny: np.ndarray
    vtx_nz: np.ndarray
    vtx_u: np.ndarray
    vtx_v: np.ndarray
    # unified per-primitive tables
    prim_mat: np.ndarray    # [P] i32
    prim_em_r: np.ndarray   # [P] f32 emission
    prim_em_g: np.ndarray
    prim_em_b: np.ndarray
    prim_flags: np.ndarray  # [P] i32
    # flattened BVH (fat nodes, ops/trace.py)
    bvh_nodes: np.ndarray   # [N,16] f32
    # megakernel prim rows (ops/megakernel.py): one 32-lane f32 record per
    # primitive with geometry, corner shading normals and the material
    # FOLDED IN, so the megakernel reads one table.  Layout:
    #   0      kind (1 tri / 2 sphere)
    #   1:4    sphere center | tri p0
    #   4:7    (radius,-,-)  | e1
    #   7:10   -             | e2
    #   10:19  -             | corner shading normals n0 n1 n2
    #   19     material type (f32-coded enum)
    #   20:23  albedo rgb      23  material param (eta / exponent)
    #   24:27  emission rgb    27  is_emitter (0/1)
    #   28     smooth-shading flag (1 = interpolate corner normals,
    #          0 = geometric normal, computed in-kernel as cross(e1,e2)
    #          so it is bit-identical to ops/shade.py's f32 math)
    prim_rows: np.ndarray   # [P_pad, 32] f32
    # background (differentiable)
    bg_r: np.ndarray        # scalar f32 arrays
    bg_g: np.ndarray
    bg_b: np.ndarray
    # point lights (NEE extension)
    light_pos: np.ndarray        # [L,3]
    light_intensity: np.ndarray  # [L,3]
    # static metadata
    num_spheres: int
    num_triangles: int
    num_nodes: int

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_triangles

    @staticmethod
    def from_pack(pack: ScenePack) -> "DeviceScene":
        f32 = np.float32
        c = pack.sph_center.astype(f32)
        prim_rows = _build_prim_rows(pack)
        p0 = pack.tri_p0.astype(f32)
        e1 = pack.tri_e1.astype(f32)
        e2 = pack.tri_e2.astype(f32)
        nrm = pack.vert_nrm.astype(f32)
        uv = pack.vert_uv.astype(f32)
        em = pack.prim_emission.astype(f32)
        return DeviceScene(
            mat_type=pack.mat_type,
            mat_r=pack.mat_color[:, 0].copy(),
            mat_g=pack.mat_color[:, 1].copy(),
            mat_b=pack.mat_color[:, 2].copy(),
            mat_param=pack.mat_param,
            sph_x=c[:, 0].copy(), sph_y=c[:, 1].copy(), sph_z=c[:, 2].copy(),
            sph_rad=pack.sph_radius.astype(f32),
            tri_p0x=p0[:, 0].copy(), tri_p0y=p0[:, 1].copy(),
            tri_p0z=p0[:, 2].copy(),
            tri_e1x=e1[:, 0].copy(), tri_e1y=e1[:, 1].copy(),
            tri_e1z=e1[:, 2].copy(),
            tri_e2x=e2[:, 0].copy(), tri_e2y=e2[:, 1].copy(),
            tri_e2z=e2[:, 2].copy(),
            tri_i0=pack.tri_vidx[:, 0].copy(),
            tri_i1=pack.tri_vidx[:, 1].copy(),
            tri_i2=pack.tri_vidx[:, 2].copy(),
            vtx_nx=nrm[:, 0].copy(), vtx_ny=nrm[:, 1].copy(),
            vtx_nz=nrm[:, 2].copy(),
            vtx_u=uv[:, 0].copy(), vtx_v=uv[:, 1].copy(),
            prim_mat=pack.prim_mat,
            prim_em_r=em[:, 0].copy(), prim_em_g=em[:, 1].copy(),
            prim_em_b=em[:, 2].copy(),
            prim_flags=pack.prim_flags,
            bvh_nodes=pack.bvh_nodes,
            prim_rows=prim_rows,
            bg_r=np.float32(pack.background[0]),
            bg_g=np.float32(pack.background[1]),
            bg_b=np.float32(pack.background[2]),
            light_pos=pack.light_pos, light_intensity=pack.light_intensity,
            num_spheres=pack.num_spheres,
            num_triangles=pack.num_triangles,
            num_nodes=pack.num_nodes,
        )

    @property
    def background(self):
        from ..ops.vec import Vec3
        return Vec3(self.bg_r, self.bg_g, self.bg_b)


def _build_prim_rows(pack: ScenePack) -> np.ndarray:
    """Pack the megakernel's fat prim records (layout documented on the
    ``prim_rows`` field).  Spheres first, triangles after — same unified id
    order as everywhere else; P padded to a multiple of 8."""
    S, F = pack.num_spheres, pack.num_triangles
    P = S + F
    Ppad = max(8, -(-P // 8) * 8)
    rows = np.zeros((Ppad, 32), np.float32)

    mat = pack.prim_mat
    rows[:P, 19] = pack.mat_type[mat].astype(np.float32)
    rows[:P, 20:23] = pack.mat_color[mat]
    rows[:P, 23] = pack.mat_param[mat]
    rows[:P, 24:27] = pack.prim_emission
    rows[:P, 27] = (np.abs(pack.prim_emission).sum(axis=1) > 0)

    if S:
        rows[:S, 0] = 2.0
        rows[:S, 1:4] = pack.sph_center
        rows[:S, 4] = pack.sph_radius
    if F:
        rows[S:P, 0] = 1.0
        rows[S:P, 1:4] = pack.tri_p0
        rows[S:P, 4:7] = pack.tri_e1
        rows[S:P, 7:10] = pack.tri_e2
        # corner shading normals (used only when the smooth flag at 28 is
        # set; flat triangles take the in-kernel cross(e1,e2) instead,
        # keeping the f32 math bit-identical to ops/shade.py)
        use_sn = (pack.prim_flags[S:P] & 1).astype(bool)
        for corner in range(3):
            vn = pack.vert_nrm[pack.tri_vidx[:, corner]]
            rows[S:P, 10 + 3 * corner:13 + 3 * corner] = \
                np.where(use_sn[:, None], vn, 0.0)
        rows[S:P, 28] = use_sn
    return rows


_FIELDS = [f.name for f in dataclasses.fields(DeviceScene)]
_STATIC = ("num_spheres", "num_triangles", "num_nodes")
_LEAVES = tuple(n for n in _FIELDS if n not in _STATIC)


def _flatten(ds: DeviceScene):
    return tuple(getattr(ds, n) for n in _LEAVES), \
        tuple(getattr(ds, n) for n in _STATIC)


def _unflatten(static, leaves) -> DeviceScene:
    kwargs = dict(zip(_LEAVES, leaves))
    kwargs.update(dict(zip(_STATIC, static)))
    return DeviceScene(**kwargs)


jax.tree_util.register_pytree_node(DeviceScene, _flatten, _unflatten)
