"""Conforming solid surface mesh + volume of a lattice (PyTorch port).

The reference builds a CAD solid (gmsh boolean union of cylinders) to get a
conforming surface/volume mesh and exact volumes
(lattice.py:1694-1963: generate_mesh_lattice_Gmsh / get_volume_mesh /
get_relative_density_mesh).  Without a CAD kernel, the equivalent is
implicit: the lattice is the zero level set of a capsule-union signed
distance field, evaluated on the device (``device``, the card by default)
in chunks of points x beams, and triangulated with marching tetrahedra
(numpy, as in the JAX package) — a watertight surface whose enclosed
volume is computed exactly from the mesh by the divergence theorem.

Accuracy is controlled by ``resolution`` (voxels across the largest axis)
and converges as O(h^2) in volume; the default reproduces analytic cylinder
volumes to <1%.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["lattice_sdf_grid", "marching_tetrahedra", "solid_mesh",
           "mesh_volume", "get_volume_mesh", "get_relative_density_mesh",
           "export_solid_mesh", "sdf_chunks", "SDF_CHUNK_BYTES"]

# the byte budget of one [B, E, 3] float32 temporary of the signed distance
SDF_CHUNK_BYTES = 1 << 26


def sdf_chunks(n_points: int, n_beams: int,
               max_bytes: int = SDF_CHUNK_BYTES) -> Tuple[int, int]:
    """(points, beams) of one chunk of the signed distance: as many beams
    as leave room for 1,024 points, then as many points as the budget
    holds, so that no [B, E, 3] float32 temporary passes ``max_bytes``
    whatever the lattice's beam count."""
    per = 3 * 4
    eb = max(1, min(n_beams, max_bytes // (per * 1024)))
    pb = max(1, min(n_points, max_bytes // (per * eb)))
    return pb, eb


def _capsule_sdf(points: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                 radius: np.ndarray, device="cuda",
                 max_bytes: int = SDF_CHUNK_BYTES) -> np.ndarray:
    """min over beams of (distance to segment - radius); [P] for [P,3],
    in float32 on ``device`` (the JAX package's jitted block), chunked
    over points x beams (``sdf_chunks``): the minimum over the beams of a
    point is taken chunk by chunk, which is exact, and the three-term dot
    products are written out elementwise, so a point's value has the same
    bits whatever the chunks."""
    from ..parallel.structured import _check_device
    dev = _check_device(device)
    f32 = torch.float32
    p1_t = torch.as_tensor(np.asarray(p1), dtype=f32, device=dev)
    d = torch.as_tensor(np.asarray(p2 - p1), dtype=f32, device=dev)  # [E,3]
    dd = torch.clamp_min(torch.sum(d * d, dim=1), 1e-30)
    r = torch.as_tensor(np.asarray(radius), dtype=f32, device=dev)
    q_all = torch.as_tensor(np.asarray(points), dtype=f32, device=dev)
    P, E = len(q_all), len(d)
    pb, eb = sdf_chunks(P, E, max_bytes)
    out = torch.empty(P, dtype=f32, device=dev)
    for i in range(0, P, pb):
        q = q_all[i:i + pb]
        best = None
        for j in range(0, E, eb):
            dj, p1j = d[j:j + eb], p1_t[j:j + eb]
            w = q[:, None, :] - p1j[None, :, :]               # [B,Ec,3]
            wd = w[..., 0] * dj[:, 0] + w[..., 1] * dj[:, 1] \
                + w[..., 2] * dj[:, 2]
            t = torch.clamp(wd / dd[j:j + eb], 0.0, 1.0)
            c = w - t[..., None] * dj[None, :, :]
            cc = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] \
                + c[..., 2] * c[..., 2]
            dist = torch.sqrt(torch.clamp_min(cc, 1e-30))
            m = torch.min(dist - r[None, j:j + eb], dim=1).values
            best = m if best is None else torch.minimum(best, m)
        out[i:i + pb] = best
    return out.cpu().numpy()


def lattice_sdf_grid(lattice, resolution: int = 96,
                     margin: Optional[float] = None, device="cuda"):
    """SDF sampled on a regular grid covering the lattice (+margin), on
    ``device``.

    Returns (sdf [nx,ny,nz], origin [3], spacing [3])."""
    rmax = float(np.max(lattice.radius)) if lattice.num_edges else 0.1
    if margin is None:
        margin = 2.0 * rmax
    lo = lattice.nodes.min(axis=0) - margin
    hi = lattice.nodes.max(axis=0) + margin
    span = hi - lo
    h = float(span.max()) / resolution
    dims = np.maximum(2, np.ceil(span / h).astype(int) + 1)
    axes = [lo[k] + h * np.arange(dims[k]) for k in range(3)]
    G = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    sdf = _capsule_sdf(G, lattice.nodes[lattice.edges[:, 0]],
                       lattice.nodes[lattice.edges[:, 1]], lattice.radius,
                       device=device)
    return sdf.reshape(tuple(dims)), lo, np.array([h, h, h])


# 6-tetrahedra decomposition of the unit cube around the main diagonal 0-7
# (consistent across cubes -> watertight isosurface)
_TETS = np.array([[0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
                  [0, 4, 7, 6], [0, 6, 7, 2], [0, 2, 7, 3]])
_CUBE = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                  [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])


def marching_tetrahedra(sdf: np.ndarray, origin: np.ndarray,
                        spacing: np.ndarray, level: float = 0.0) -> np.ndarray:
    """Triangulate the ``level`` isosurface; returns triangles [T,3,3].

    Vectorized marching tetrahedra: every cube splits into 6 tetrahedra
    sharing the main diagonal; each tetrahedron with a sign change yields
    one or two triangles with edge-interpolated vertices.  The diagonal is
    consistent across cubes, so the surface is watertight and consistently
    oriented (normals point toward positive SDF = outward).
    """
    nx, ny, nz = sdf.shape
    vals = sdf - level
    # corner values per cube [C, 8]
    c000 = vals[:-1, :-1, :-1]
    shape = c000.shape
    corner_vals = np.stack([
        vals[_CUBE[k, 0]:, :, :][:shape[0], :, :]
        [:, _CUBE[k, 1]:, :][:, :shape[1], :]
        [:, :, _CUBE[k, 2]:][:, :, :shape[2]]
        for k in range(8)], axis=-1).reshape(-1, 8)          # [C,8]
    ii, jj, kk = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             np.arange(shape[2]), indexing="ij")
    base = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)    # [C,3]

    # cull cubes with no sign change
    has = (corner_vals.min(axis=1) < 0) & (corner_vals.max(axis=1) > 0)
    corner_vals = corner_vals[has]
    base = base[has]
    if len(base) == 0:
        return np.zeros((0, 3, 3))

    corner_pos = (base[:, None, :] + _CUBE[None, :, :]) * spacing + origin

    tris = []
    for tet in _TETS:
        tv = corner_vals[:, tet]                             # [C,4]
        tp = corner_pos[:, tet]                              # [C,4,3]
        inside = tv < 0                                      # [C,4]
        n_in = inside.sum(axis=1)

        def interp(sel, a, b):
            """zero crossing on edge a-b for selected tets."""
            va, vb = tv[sel, a], tv[sel, b]
            t = va / (va - vb)
            return tp[sel, a] + t[:, None] * (tp[sel, b] - tp[sel, a])

        # enumerate the 14 non-trivial sign patterns via lexicographic cases
        for n, flip_out in ((1, False), (3, True)):
            # one vertex on its own side -> single triangle
            sel_n = n_in == n
            if not sel_n.any():
                continue
            iso = inside if n == 1 else ~inside
            for v in range(4):
                sel = sel_n & iso[:, v]
                if not sel.any():
                    continue
                others = [o for o in range(4) if o != v]
                pa = interp(sel, v, others[0])
                pb = interp(sel, v, others[1])
                pc = interp(sel, v, others[2])
                tri = np.stack([pa, pb, pc], axis=1)
                # orient: normal toward positive side
                n_vec = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
                out_dir = tp[sel, others[0]] + tp[sel, others[1]] \
                    + tp[sel, others[2]] - 3 * tp[sel, v]
                if n == 3:
                    out_dir = -out_dir
                s = np.sign(np.einsum("ij,ij->i", n_vec, out_dir))
                tri[s < 0] = tri[s < 0][:, [0, 2, 1]]
                tris.append(tri)
        # two-two split -> quad = two triangles
        sel2 = n_in == 2
        if sel2.any():
            for pair in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
                a, b = pair
                sel = sel2 & inside[:, a] & inside[:, b]
                if not sel.any():
                    continue
                c, d = [o for o in range(4) if o not in pair]
                pac = interp(sel, a, c)
                pad = interp(sel, a, d)
                pbc = interp(sel, b, c)
                pbd = interp(sel, b, d)
                for tri in (np.stack([pac, pbc, pbd], axis=1),
                            np.stack([pac, pbd, pad], axis=1)):
                    n_vec = np.cross(tri[:, 1] - tri[:, 0],
                                     tri[:, 2] - tri[:, 0])
                    out_dir = (tp[sel, c] + tp[sel, d]
                               - tp[sel, a] - tp[sel, b])
                    s = np.sign(np.einsum("ij,ij->i", n_vec, out_dir))
                    tri = tri.copy()
                    tri[s < 0] = tri[s < 0][:, [0, 2, 1]]
                    tris.append(tri)
    if not tris:
        return np.zeros((0, 3, 3))
    out = np.concatenate(tris, axis=0)
    # drop zero-area triangles (corner exactly on the isosurface)
    area = np.linalg.norm(np.cross(out[:, 1] - out[:, 0],
                                   out[:, 2] - out[:, 0]), axis=1)
    return out[area > 1e-14]


def mesh_volume(triangles: np.ndarray) -> float:
    """Enclosed volume of a closed, outward-oriented triangle mesh
    (divergence theorem: V = -sum det[p0 p1 p2]/6 for outward normals)."""
    if len(triangles) == 0:
        return 0.0
    det = np.einsum("ij,ij->i", triangles[:, 0],
                    np.cross(triangles[:, 1], triangles[:, 2]))
    return float(abs(det.sum()) / 6.0)


def solid_mesh(lattice, resolution: int = 96, device="cuda") -> np.ndarray:
    """Watertight triangle mesh [T,3,3] of the lattice solid."""
    sdf, origin, spacing = lattice_sdf_grid(lattice, resolution,
                                            device=device)
    return marching_tetrahedra(sdf, origin, spacing)


def get_volume_mesh(lattice, resolution: int = 96,
                    device="cuda") -> Tuple[float, np.ndarray]:
    """(volume, triangles): mesh-based solid volume
    (get_volume_mesh parity, lattice.py:1883-1940)."""
    tris = solid_mesh(lattice, resolution, device=device)
    return mesh_volume(tris), tris


def get_relative_density_mesh(lattice, resolution: int = 96,
                              device="cuda") -> float:
    """Solid volume / bounding-box volume
    (get_relative_density_mesh parity, lattice.py:1943-1960)."""
    v, _ = get_volume_mesh(lattice, resolution, device=device)
    b = lattice.get_lattice_boundary_box()
    vbox = (b[1] - b[0]) * (b[3] - b[2]) * (b[5] - b[4])
    return v / vbox


def export_solid_mesh(path, lattice, resolution: int = 96,
                      device="cuda") -> np.ndarray:
    """Write the conforming solid surface as STL (binary) or gmsh .msh,
    chosen by extension (generate_mesh_lattice_Gmsh parity)."""
    import struct

    tris = solid_mesh(lattice, resolution, device=device)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".msh":
        from .export import write_msh_triangles
        pts, inv = np.unique(tris.reshape(-1, 3).round(9), axis=0,
                             return_inverse=True)
        write_msh_triangles(path, pts, inv.reshape(-1, 3))
    else:
        t32 = tris.astype(np.float32)
        normals = np.cross(t32[:, 1] - t32[:, 0], t32[:, 2] - t32[:, 0])
        nn = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(nn == 0, 1, nn)
        with open(path, "wb") as fh:
            fh.write(b"\0" * 80)
            fh.write(struct.pack("<I", len(t32)))
            for k in range(len(t32)):
                fh.write(normals[k].astype(np.float32).tobytes())
                fh.write(t32[k].tobytes())
                fh.write(b"\0\0")
    return tris
