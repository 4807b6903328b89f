"""Host-side result/geometry export: Paraview VTU/PVD, Grasshopper JSON, STL.

Replaces the reference's dolfinx/gmsh-backed writers
(export_simulation_results.py:35-649, utils.py:364-425) with standalone
array-based writers: lattices are line-cell unstructured grids with per-node
6-DOF fields and per-beam data; the 3D visualization path emits a cylinder
surface STL per beam.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["write_vtu", "write_pvd", "export_simulation_vtu",
           "save_json_to_grasshopper", "write_stl_cylinders",
           "write_stl_rough_wires", "write_stl_rough_wires_pyrough",
           "write_msh_triangles",
           "export_homogenization_surface_msh"]


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def write_vtu(path, points: np.ndarray, lines: np.ndarray,
              point_data: Optional[Dict[str, np.ndarray]] = None,
              cell_data: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Minimal VTU (XML, base64-inline) writer for line meshes."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    lines = np.ascontiguousarray(lines, dtype=np.int64)
    n_pts, n_cells = len(points), len(lines)
    conn = lines.reshape(-1)
    offsets = 2 * (np.arange(n_cells, dtype=np.int64) + 1)
    types = np.full(n_cells, 3, dtype=np.uint8)  # VTK_LINE

    def data_arrays(data, n_expected):
        out = []
        for name, arr in (data or {}).items():
            arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            assert len(arr) == n_expected, f"{name}: {len(arr)} != {n_expected}"
            out.append(
                f'<DataArray type="Float64" Name="{name}" '
                f'NumberOfComponents="{ncomp}" format="binary">{_b64(arr)}</DataArray>')
        return "\n".join(out)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" header_type="UInt32">
<UnstructuredGrid>
<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
<Points>
<DataArray type="Float64" NumberOfComponents="3" format="binary">{_b64(points)}</DataArray>
</Points>
<Cells>
<DataArray type="Int64" Name="connectivity" format="binary">{_b64(conn)}</DataArray>
<DataArray type="Int64" Name="offsets" format="binary">{_b64(offsets)}</DataArray>
<DataArray type="UInt8" Name="types" format="binary">{_b64(types)}</DataArray>
</Cells>
<PointData>
{data_arrays(point_data, n_pts)}
</PointData>
<CellData>
{data_arrays(cell_data, n_cells)}
</CellData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    Path(path).write_text(xml)


def write_pvd(path, vtu_files: Sequence, timesteps: Optional[Sequence[float]] = None) -> None:
    """Paraview collection file referencing per-step VTUs."""
    timesteps = timesteps or list(range(len(vtu_files)))
    entries = "\n".join(
        f'<DataSet timestep="{t}" group="" part="0" file="{Path(f).name}"/>'
        for t, f in zip(timesteps, vtu_files))
    Path(path).write_text(
        '<?xml version="1.0"?>\n<VTKFile type="Collection" version="0.1">\n'
        f"<Collection>\n{entries}\n</Collection>\n</VTKFile>\n")


def export_simulation_vtu(path, lattice, result=None) -> None:
    """Lattice + optional FEM/DDM result -> VTU with the reference's field
    set (displacement/rotation/reaction, per-beam radius/type)."""
    point_data = {"tag": lattice.node_tag.astype(np.float64)}
    if result is not None:
        u = np.asarray(result.u)
        point_data["displacement"] = u[:, :3]
        point_data["rotation"] = u[:, 3:]
        point_data["reaction_force"] = np.asarray(result.reaction)[:, :3]
        point_data["reaction_moment"] = np.asarray(result.reaction)[:, 3:]
    cell_data = {
        "radius": lattice.radius,
        "geometry_type": lattice.edge_type.astype(np.float64),
        "material": lattice.edge_mat.astype(np.float64),
        "cell_index": lattice.edge_cell.astype(np.float64),
    }
    write_vtu(path, lattice.nodes, lattice.edges, point_data, cell_data)


def save_json_to_grasshopper(lattice, path, multiple_parts: int = 1) -> list:
    """Rhino/Grasshopper interop JSON: flattened beam endpoint coordinate
    lists + radii + bbox + relative density (utils.py:364-425 schema)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    C = lattice.num_cells
    per_part = max(1, C // multiple_parts)
    bbox = lattice.get_lattice_boundary_box()
    written = []
    for part in range(multiple_parts):
        cells = range(part * per_part, min((part + 1) * per_part, C))
        eids = np.unique(np.concatenate([
            lattice.cell_edge_idx[lattice.cell_edge_ptr[c]:lattice.cell_edge_ptr[c + 1]]
            for c in cells]) if len(cells) else np.array([], dtype=int))
        p1 = lattice.nodes[lattice.edges[eids, 0]]
        p2 = lattice.nodes[lattice.edges[eids, 1]]
        obj = {
            "nodesX": np.stack([p1[:, 0], p2[:, 0]], 1).reshape(-1).tolist(),
            "nodesY": np.stack([p1[:, 1], p2[:, 1]], 1).reshape(-1).tolist(),
            "nodesZ": np.stack([p1[:, 2], p2[:, 2]], 1).reshape(-1).tolist(),
            "radii": lattice.radius[eids].tolist(),
            "maxX": bbox[1], "minX": bbox[0],
            "maxY": bbox[3], "minY": bbox[2],
            "maxZ": bbox[5], "minZ": bbox[4],
            "relativeDensity": lattice.get_relative_density(),
        }
        out = path if multiple_parts == 1 else \
            path.with_name(f"{path.stem}_part{part + 1}{path.suffix}")
        out.write_text(json.dumps(obj))
        written.append(out)
    return written


def write_stl_cylinders(path, lattice, n_sides: int = 12,
                        radius_scale: float = 1.0,
                        roughness: float = 0.0, roughness_seed: int = 0,
                        n_axial: int = 1) -> None:
    """Binary STL of every beam as an open cylinder surface
    (export_vizualisation_3D parity, export_simulation_results.py:331).

    ``roughness`` > 0 perturbs the surface radially with Gaussian noise of
    that standard deviation (in radius units) on an ``n_axial``-segment
    tube — the array-based stand-in for the reference's optional Pyrough
    rough-surface STL generator (lattice.py:1966-2143)."""
    rng = np.random.default_rng(roughness_seed)
    tris = []
    for (a, b), r in zip(lattice.edges, lattice.radius * radius_scale):
        p1, p2 = lattice.nodes[a], lattice.nodes[b]
        axis = p2 - p1
        L = np.linalg.norm(axis)
        if L == 0:
            continue
        t = axis / L
        ref = np.array([0.0, 0.0, 1.0]) if abs(t[2]) < 0.99 else np.array([1.0, 0.0, 0.0])
        u = np.cross(ref, t); u /= np.linalg.norm(u)
        v = np.cross(t, u)
        ang = 2 * np.pi * np.arange(n_sides) / n_sides
        ring = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v
        n_seg = max(1, int(n_axial))
        stations = [p1 + (p2 - p1) * (k / n_seg) for k in range(n_seg + 1)]
        rings = []
        for p in stations:
            rr = r
            if roughness > 0:
                rr = r * (1.0 + roughness * rng.standard_normal(n_sides))[:, None]
            rings.append(p + rr * ring)
        for lo, hi in zip(rings[:-1], rings[1:]):
            for i in range(n_sides):
                j = (i + 1) % n_sides
                tris.append((lo[i], lo[j], hi[i]))
                tris.append((hi[i], lo[j], hi[j]))
        _append_end_caps(tris, p1, p2, rings[0], rings[-1])
    _write_stl_binary(path, tris)


def _self_affine_height(n_axial: int, n_sides: int, eta: float, rms: float,
                        n_cut: int, m_cut: int, rng) -> np.ndarray:
    """Self-affine random-phase surface h[z, theta] (Pyrough wire model).

    Spectral synthesis: Fourier amplitude |h_k| ~ |k|^-(1+eta) (eta the
    Hurst-like exponent) band-limited to |k_z| <= n_cut, |k_theta| <= m_cut,
    uniform random phases, normalized to the requested RMS.  Matches the
    statistical model of Pyrough's ``make_wire`` (its C1/eta/N/M/RMS
    parameters map directly); periodic in theta by construction.
    """
    kz = np.fft.fftfreq(n_axial) * n_axial
    kt = np.fft.fftfreq(n_sides) * n_sides
    KZ, KT = np.meshgrid(kz, kt, indexing="ij")
    k2 = KZ * KZ + KT * KT
    mask = (k2 > 0) & (np.abs(KZ) <= n_cut) & (np.abs(KT) <= m_cut)
    with np.errstate(divide="ignore"):
        amp = np.where(mask, np.power(k2, -(1.0 + eta) / 2.0,
                                      where=mask, out=np.zeros_like(k2)), 0.0)
    phase = rng.uniform(0.0, 2.0 * np.pi, amp.shape)
    h = np.fft.ifft2(amp * np.exp(1j * phase)).real
    std = h.std()
    return h * (rms / std if std > 0 else 0.0)


def write_stl_rough_wires(path, lattice, eta: float = 0.8, rms: float = 0.05,
                          n_cut: int = 30, m_cut: int = 8,
                          n_sides: int = 24, n_axial: int = 40,
                          seed: int = 0, taper: float = 0.15,
                          radius_scale: float = 1.0) -> None:
    """Binary STL of every beam as a SELF-AFFINE rough wire — the
    statistical surface model of the reference's Pyrough integration
    (generate_mesh_lattice_rough, lattice.py:1966-2143; Pyrough
    ``make_wire`` with exponent ``2(1+eta)``, cutoffs N/M, RMS scaling),
    implemented dependency-free with random-phase spectral synthesis.

    ``rms`` is the roughness RMS in units of the beam radius; ``taper``
    smoothly suppresses the roughness over that fraction of the beam
    length at each end so junctions stay watertight-ish.
    """
    rng = np.random.default_rng(seed)
    tris = []
    ang = 2 * np.pi * np.arange(n_sides) / n_sides
    for (a, b), r in zip(lattice.edges, lattice.radius * radius_scale):
        p1, p2 = lattice.nodes[a], lattice.nodes[b]
        axis = p2 - p1
        L = np.linalg.norm(axis)
        if L == 0 or r <= 0:
            continue
        t = axis / L
        ref = np.array([0.0, 0.0, 1.0]) if abs(t[2]) < 0.99 \
            else np.array([1.0, 0.0, 0.0])
        u = np.cross(ref, t); u /= np.linalg.norm(u)
        v = np.cross(t, u)
        ring = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v  # [S,3]
        h = _self_affine_height(n_axial + 1, n_sides, eta, rms * r,
                                n_cut, m_cut, rng)                  # [Z,S]
        z_hat = np.arange(n_axial + 1) / n_axial
        w = np.clip(np.minimum(z_hat, 1.0 - z_hat) / max(taper, 1e-9),
                    0.0, 1.0)
        rr = r + h * w[:, None]                                     # [Z,S]
        rings = [p1 + axis * z + rr[k][:, None] * ring
                 for k, z in enumerate(z_hat)]
        for lo, hi in zip(rings[:-1], rings[1:]):
            for i in range(n_sides):
                j = (i + 1) % n_sides
                tris.append((lo[i], lo[j], hi[i]))
                tris.append((hi[i], lo[j], hi[j]))
        _append_end_caps(tris, p1, p2, rings[0], rings[-1])
    _write_stl_binary(path, tris)


def write_stl_rough_wires_pyrough(path, lattice, pyrough_config,
                                  **overrides) -> dict:
    """Config-driven rough-wire STL from a Pyrough parameter JSON.

    Accepts the reference's Pyrough schema
    (data/inputs/preset_lattice/Pyrough/lattice_wire.json; reference
    lattice.py:1966-2143 passes it to Pyrough's ``make_wire``):
    ``cWire`` keys Radius, C1 (RMS roughness amplitude in length units),
    eta (self-affine exponent), N / M (axial / angular spectral cutoffs).
    Mesh_size sets the surface discretization (ring spacing along the
    wire and around it).  Returns the resolved generator kwargs.
    """
    import json as _json

    if isinstance(pyrough_config, (str, Path)):
        with open(pyrough_config) as fh:
            pyrough_config = _json.load(fh)
    cw = pyrough_config["cWire"]
    radius = float(cw.get("Radius", float(np.median(lattice.radius))))
    mesh = float(cw.get("Mesh_size", radius / 4.0))
    length = float(cw.get("Length", 1.0))
    kw = dict(
        eta=float(cw.get("eta", 0.8)),
        rms=float(cw.get("C1", 0.05 * radius)) / radius,
        n_cut=int(cw.get("N", 300)),
        m_cut=int(cw.get("M", 30)),
        # ring spacing ~ Mesh_size along and around the wire
        n_axial=max(8, int(round(length / mesh))),
        n_sides=max(8, int(round(2 * np.pi * radius / mesh))),
    )
    kw.update(overrides)
    write_stl_rough_wires(path, lattice, **kw)
    return kw


def _append_end_caps(tris, p1, p2, ring_lo, ring_hi) -> None:
    """Triangle-fan end caps closing a tube so the STL is watertight."""
    n = len(ring_lo)
    for i in range(n):
        j = (i + 1) % n
        tris.append((p1, ring_lo[j], ring_lo[i]))
        tris.append((p2, ring_hi[i], ring_hi[j]))


def _write_stl_binary(path, tris) -> None:
    """Binary STL from a list/array of (3, 3) facets (empty-safe)."""
    tris = np.asarray(tris, dtype=np.float32).reshape(-1, 3, 3)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(struct.pack("<I", len(tris)))
        normals = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(norms == 0, 1, norms)
        for k in range(len(tris)):
            fh.write(normals[k].astype(np.float32).tobytes())
            fh.write(tris[k].tobytes())
            fh.write(b"\0\0")


def write_msh_triangles(path, points: np.ndarray, triangles: np.ndarray) -> None:
    """ASCII gmsh MSH 2.2 file from a triangle soup (no gmsh dependency).

    ``points`` [N, 3]; ``triangles`` [T, 3] 0-based node indices.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        fh.write(f"$Nodes\n{len(points)}\n")
        for i, (x, y, z) in enumerate(points, start=1):
            fh.write(f"{i} {x:.10g} {y:.10g} {z:.10g}\n")
        fh.write("$EndNodes\n")
        fh.write(f"$Elements\n{len(triangles)}\n")
        for i, (a, b, c) in enumerate(triangles, start=1):
            # type 2 = 3-node triangle; two tags: physical 0, elementary 1
            fh.write(f"{i} 2 2 0 1 {a + 1} {b + 1} {c + 1}\n")
        fh.write("$EndElements\n")


def export_homogenization_surface_msh(path, C: np.ndarray, n_theta: int = 90,
                                      n_phi: int = 180,
                                      fit_box: Optional[Sequence] = None) -> None:
    """Directional-stiffness surface E(theta, phi) as a gmsh ``.msh``
    (export_homogenization_surface_paraview parity,
    export_simulation_results.py:232-330).

    ``C``: 6x6 homogenized stiffness (Voigt).  ``fit_box`` (sx, sy, sz)
    rescales the surface per axis to fit half the lattice box, as the
    reference does when a lattice is attached.
    """
    from ..fem.homogenization import directional_modulus

    th = np.linspace(0.0, np.pi, n_theta)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    E = directional_modulus(np.asarray(C), TH, PH)
    pts = np.stack([E * np.sin(TH) * np.cos(PH),
                    E * np.sin(TH) * np.sin(PH),
                    E * np.cos(TH)], axis=-1).reshape(-1, 3)
    if fit_box is not None:
        maxabs = np.maximum(np.max(np.abs(pts), axis=0), 1e-12)
        pts = pts * (0.5 * np.asarray(fit_box, dtype=float) / maxabs)

    tris = []
    for i in range(n_theta - 1):
        for j in range(n_phi - 1):
            n0 = i * n_phi + j
            n1 = n0 + 1
            n2 = n0 + n_phi
            n3 = n2 + 1
            tris.append([n0, n1, n3])
            tris.append([n0, n3, n2])
    write_msh_triangles(path, pts, np.asarray(tris))
