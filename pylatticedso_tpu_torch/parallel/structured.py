"""Structured stencil operator for uniform periodic lattices (PyTorch).

A uniform lattice (one unit-cell template tiled on a regular grid) is not an
unstructured graph: its nodes decompose into a few CLASSES — the unique
template-node positions modulo the cell — each living on a regular
(Nx+1, Ny+1, Nz+1) grid, and its beams into a few TEMPLATE EDGES, each
connecting class A at cell g to class B at cell g + d for a constant integer
offset d and a constant local frame.

K.u then becomes, per template edge, dense shifted-slice arithmetic over
[6, X, Y, Z] class fields.  The host build (class decomposition, creator
priority, validity masks) is numpy and mirrors
``pylatticedso_tpu.parallel.structured`` line for line; the operator is
plain torch (the gather form, the oracle of the B1 stencil kernel), and
``make_matvec`` routes every K.u application through the kernel wrapper
``kernels.stencil.StencilMatvec`` — the hand-written CUDA kernel on a
CUDA tensor, the gather form on a CPU tensor.

Scope of this module: uniform cell size, no penalization; single-geometry
and hybrid (superposed multi-geometry) templates, erased cells,
node-granular trimming and warped lattices (``node_transform``: per-instance
frame and length fields, the warped B1 kernel on a CUDA tensor); the step
with every objective, imposed displacements and gradient form of the JAX
package, and ``shard_structured_step`` on a mesh (``parallel/slabs.py``).
The scatter form
(``matvec.apply_scatter``) is a plain torch form in a fixed order; the port
reads no ``PLDSO_MATVEC``, so on a CUDA tensor the operator is always B1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..catalog import get_beam_structure
from ..kernels.fused import FusedSmoother
from ..kernels.stencil import LatticeSlab, StencilMatvec, edge_sides
from ..utils.timing import timing
from .mesh import check_device as _check_device

__all__ = ["StructuredLattice", "make_structured_compliance_step",
           "shard_structured_step"]


def _split_template_collisions(templates, tol: float = 1e-9):
    """Split template beams at other template points lying strictly inside
    them (colinear, 0 < t < 1) — design/lattice.py's hybrid collision rule
    applied once at TEMPLATE level.  Superposition is identical in every
    cell, so one template split reproduces the per-cell splitting globally;
    split points are other geometries' nodes, so the class set is
    unchanged."""
    pts = np.unique(np.round(np.concatenate(
        [t.reshape(-1, 3) for t in templates]), 9), axis=0)
    out = []
    for tpl in templates:
        segs = []
        for beam in tpl:
            p1, p2 = beam[:3], beam[3:]
            v = p2 - p1
            L2 = float(v @ v)
            w = pts - p1
            cr = np.cross(np.broadcast_to(v, pts.shape), w)
            colinear = (cr * cr).sum(1) <= (tol * np.sqrt(max(L2, 1e-300))) ** 2
            t = (w @ v) / max(L2, 1e-300)
            interior = colinear & (t > 1e-12) & (t < 1.0 - 1e-12)
            chain = ([p1] + [p1 + tt * v for tt in np.sort(t[interior])]
                     + [p2])
            for a, b in zip(chain[:-1], chain[1:]):
                segs.append(np.concatenate([a, b]))
        out.append(np.asarray(segs))
    return out


def _class_decomposition(templates):
    """Template beams -> node classes + normalized template edges.

    ``templates``: one [n_beams, 2, 3] array per geometry.  Hybrid lattices
    SUPERPOSE every geometry's beams in every cell, each geometry carrying
    its own per-cell radius; classes are merged across geometries by their
    9-digit fractional key and template edges by their canonical
    (class, offset) form, with each creator tagged by its source geometry.

    Returns (class_keys [nc,3], edges: list of dicts with class ids, offset,
    endpoint fractional positions, creator (shift, geometry) pairs).
    """
    pts_all, geom_of_beam = [], []
    for gi, template in enumerate(templates):
        pts_all.append(template.reshape(-1, 3))
        geom_of_beam.extend([gi] * len(template))
    pts = np.concatenate(pts_all)
    offs = np.floor(pts + 1e-12).astype(np.int64)          # 1.0 -> next cell
    keys = np.round(pts - offs, 9)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)

    # pre-dedup per-class cell offsets: class-c node at grid q exists iff a
    # cell q - o exists for some original template offset o of that class
    class_offsets = [set() for _ in range(len(uniq))]
    for i in range(len(pts)):
        class_offsets[int(inv[i])].add(tuple(offs[i].tolist()))

    edges = {}
    for b in range(len(pts) // 2):
        ia, ib = 2 * b, 2 * b + 1
        gi = geom_of_beam[b]
        ca, cb = int(inv[ia]), int(inv[ib])
        oa, ob = offs[ia], offs[ib]
        # canonical form: shift both offsets by their componentwise min (the
        # same physical stencil created by neighboring cells differs only by
        # a uniform shift) and order the endpoints deterministically
        s = np.minimum(oa, ob)
        oa2, ob2 = tuple((oa - s).tolist()), tuple((ob - s).tolist())
        ka, kb = keys[ia], keys[ib]
        if ((cb,) + ob2) < ((ca,) + oa2):
            oa2, ob2, ca, cb, ka, kb = ob2, oa2, cb, ca, kb, ka
        canon = ((ca,) + oa2, (cb,) + ob2)
        if canon not in edges:
            edges[canon] = {
                "ca": ca, "cb": cb, "oa": oa2, "ob": ob2,
                "fa": np.asarray(oa2) + ka,   # A position rel. anchor cell
                "fb": np.asarray(ob2) + kb,
                "shifts": set(),
            }
        # an instance at anchor g is created by cell g - s (of geometry gi)
        edges[canon]["shifts"].add(tuple(s.tolist()) + (gi,))
    return uniq, list(edges.values()), class_offsets


@dataclass
class StructuredLattice:
    """Class-grid representation of a uniform lattice.

    ``geom`` may be one geometry name or a sequence of names: a HYBRID
    lattice superposes every geometry's beams in every cell, and the radius
    argument of the operators then accepts an extra leading geometry axis
    ([n_geom, Nx, Ny, Nz]; lower-rank radii broadcast to all geometries).
    ``dtype`` is a torch dtype and ``device`` the torch device the
    operators build their tensors on (the host build is numpy).
    """

    geom: object                               # str | Sequence[str]
    num_cells: Tuple[int, int, int]
    cell_size: Tuple[float, float, float]
    E_mod: float
    nu: float
    kappa: float = 0.9
    dtype: torch.dtype = torch.float32
    cell_valid: Optional[np.ndarray] = None   # [Nx,Ny,Nz] bool (erasure)
    node_keep: Optional[object] = None        # [nc,X,Y,Z] bool or p(x,y,z)
    # warped lattices: the transform moves nodes but keeps the grid
    # topology, so K.u stays a stencil whose per-edge frame and length
    # become per-instance grid fields (topology-changing transforms, such
    # as a cylindrical seam merge, route through parallel.sharding)
    node_transform: Optional[object] = None   # f(x, y, z) -> (x', y', z')
    device: object = "cuda"

    def __post_init__(self):
        self.geoms = ([self.geom] if isinstance(self.geom, str)
                      else list(self.geom))
        self.n_geom = len(self.geoms)
        tpls = [get_beam_structure(g) for g in self.geoms]
        if self.n_geom > 1:
            tpls = _split_template_collisions(tpls)
        self.class_keys, self.edges, class_offsets = _class_decomposition(tpls)
        self.nc = len(self.class_keys)
        nx, ny, nz = self.num_cells
        self.grid = (nx + 1, ny + 1, nz + 1)
        csz = np.asarray(self.cell_size)
        if self.cell_valid is None:
            self.cell_valid = np.ones(self.num_cells, dtype=bool)
        # cell validity padded by one ghost layer on every side, so creator
        # lookups g - s index with non-negative slices
        cvp = np.zeros((nx + 2, ny + 2, nz + 2), dtype=bool)
        cvp[1:nx + 1, 1:ny + 1, 1:nz + 1] = self.cell_valid

        # per-edge constants: frame, length, instance extent, creator masks
        for e in self.edges:
            vec = (np.asarray(e["fb"]) - np.asarray(e["fa"])) * csz
            L = float(np.linalg.norm(vec))
            t = vec / L
            ref = np.array([1.0, 0, 0]) if abs(t[2]) > 0.99 else np.array([0, 0, 1.0])
            a1 = np.cross(ref, t); a1 /= np.linalg.norm(a1)
            a2 = np.cross(t, a1)
            e["L"], e["t"], e["a1"], e["a2"] = L, t, a1, a2
            m = np.maximum(e["oa"], e["ob"])
            ext = (nx + 1 - m[0], ny + 1 - m[1], nz + 1 - m[2])
            e["ext"] = ext
            # creator priority: the reference's first-wins dedup keeps the
            # earliest-generated creating cell = smallest index = largest s;
            # within one cell, geometries generate in geom_types order, so
            # the SMALLEST geometry index wins.  Iteration order below is
            # lowest-priority FIRST (later entries overwrite).
            shifts = sorted(e["shifts"],
                            key=lambda p: (p[:3], -p[3]))
            e["creators"] = shifts                 # (sx, sy, sz, gi) tuples
            inst = np.zeros(ext, dtype=bool)
            for s in shifts:
                sl = tuple(slice(1 - s[ax], 1 - s[ax] + ext[ax]) for ax in range(3))
                inst |= cvp[sl]
            e["inst_valid"] = inst

        # node-class validity from the pre-dedup template offsets
        X, Y, Z = self.grid
        gx, gy, gz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                 indexing="ij")
        self.node_valid = np.zeros((self.nc,) + self.grid, dtype=bool)
        for c in range(self.nc):
            ok = np.zeros(self.grid, dtype=bool)
            for o in class_offsets[c]:
                sl = tuple(slice(1 - o[ax], 1 - o[ax] + self.grid[ax])
                           for ax in range(3))
                ok |= cvp[sl]
            self.node_valid[c] = ok

        # node world positions (for BC selection)
        self.class_pos = {}
        for c, key in enumerate(self.class_keys):
            px = (gx + key[0]) * csz[0]
            py = (gy + key[1]) * csz[1]
            pz = (gz + key[2]) * csz[2]
            self.class_pos[c] = np.stack([px, py, pz])

        # warped lattices: transform positions, then derive per-edge
        # per-INSTANCE frames and lengths (grid fields) from the transformed
        # endpoints, with the unstructured path's branchless reference-axis
        # rule (fem/elements.edge_geometry), so the two operators agree bit
        # for bit on the same warped lattice
        if self.node_transform is not None:
            # unwarped positions kept for the structured optimizer, which
            # maps lattice nodes in PRE-transform coordinates
            self.class_pos_unwarped = {c: self.class_pos[c].copy()
                                       for c in range(self.nc)}
            for c in range(self.nc):
                x, y, z = self.class_pos[c]
                self.class_pos[c] = np.stack(self.node_transform(x, y, z))
            for e in self.edges:
                ext, oa, ob = e["ext"], e["oa"], e["ob"]
                sa = (slice(None),) + tuple(
                    slice(oa[ax], oa[ax] + ext[ax]) for ax in range(3))
                sb = (slice(None),) + tuple(
                    slice(ob[ax], ob[ax] + ext[ax]) for ax in range(3))
                pA = self.class_pos[e["ca"]][sa]
                pB = self.class_pos[e["cb"]][sb]              # [3, ext]
                vec = pB - pA
                L = np.linalg.norm(vec, axis=0)
                Ls = np.where(L > 0, L, 1.0)   # collapsed-instance guard
                t = vec / Ls
                ex_ = np.array([1.0, 0.0, 0.0])[:, None, None, None]
                ez_ = np.array([0.0, 0.0, 1.0])[:, None, None, None]
                ref = np.where(np.abs(t[2]) > 0.99, ex_, ez_)
                a1 = np.cross(ref, t, axisa=0, axisb=0, axisc=0)
                a1n = np.linalg.norm(a1, axis=0)
                a1 = a1 / np.where(a1n > 0, a1n, 1.0)
                a2 = np.cross(t, a1, axisa=0, axisb=0, axisc=0)
                e["warp_frames"] = np.stack([t, a1, a2])      # [3, 3, ext]
                e["warp_L"] = Ls

        # node-granular trimming: drop nodes outside ``node_keep``, remove
        # every beam instance touching a dropped endpoint, then prune
        # orphaned nodes (design/mesh_trimmer.py's pass at class-grid level)
        if self.node_keep is not None:
            keep = self.node_keep
            if callable(keep):
                k = np.zeros((self.nc,) + self.grid, dtype=bool)
                for c in range(self.nc):
                    x, y, z = self.class_pos[c]
                    k[c] = keep(x, y, z)
                keep = k
            self.node_valid &= np.asarray(keep, dtype=bool)
            used = np.zeros_like(self.node_valid)
            for e in self.edges:
                ext, oa, ob = e["ext"], e["oa"], e["ob"]
                sa = tuple(slice(oa[ax], oa[ax] + ext[ax]) for ax in range(3))
                sb = tuple(slice(ob[ax], ob[ax] + ext[ax]) for ax in range(3))
                ka = self.node_valid[e["ca"]][sa]
                kb = self.node_valid[e["cb"]][sb]
                e["inst_valid"] = e["inst_valid"] & ka & kb
                used[e["ca"]][sa] |= e["inst_valid"]
                used[e["cb"]][sb] |= e["inst_valid"]
            self.node_valid &= used

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return int(self.node_valid.sum())

    @property
    def n_edges(self) -> int:
        return len(self.edges) * int(np.prod(self.num_cells))

    def node_field(self, fill: float = 0.0) -> np.ndarray:
        """Fresh [nc, 6, X, Y, Z] nodal field."""
        return np.full((self.nc, 6) + self.grid, fill, dtype=np.float32)

    def select_nodes(self, predicate) -> np.ndarray:
        """Boolean [nc, X, Y, Z] mask from a coordinate predicate p(x,y,z)."""
        out = np.zeros((self.nc,) + self.grid, dtype=bool)
        for c in range(self.nc):
            x, y, z = self.class_pos[c]
            out[c] = predicate(x, y, z) & self.node_valid[c]
        return out

    # ------------------------------------------------------------------
    def make_matvec(self):
        """Dense stencil K.u over [nc, 6, X, Y, Z] fields.

        Returns (matvec, diag).  ``matvec(u, radius)`` =
        ``matvec.apply(u, matvec.prepare(radius))``, where ``apply`` is the
        B1 kernel wrapper (kernel on CUDA, gather form on CPU; the warped
        B1 on a warped lattice), with ``apply.lo`` its bf16-I/O form (B2)
        and ``apply.fused`` the fused smoother kernels B3-B5 of the
        multigrid; ``matvec.apply_gather`` is the plain gather form itself,
        ``matvec.apply_scatter(u, radius)`` the instance-anchored scatter
        form, ``matvec.sections`` / ``matvec.energy_dr2`` serve the
        analytic gradient, and ``matvec.slab(axis, n, k, device)`` is the
        operator on slab k of n along a grid axis (``parallel/slabs.py``).
        ``radius`` is [Nx, Ny, Nz] (per cell), [n_geom,
        Nx, Ny, Nz] (hybrid) or a scalar.
        """
        dev = _check_device(self.device)
        nx, ny, nz = self.num_cells
        E_mod, nu, kappa = self.E_mod, self.nu, self.kappa
        G_mod = E_mod / (2.0 * (1.0 + nu))
        dt = self.dtype
        warped = self.node_transform is not None
        tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        geoP = None
        if warped:
            # ghost-padded per-edge geometry fields, JAX's geoP: rows 0-8
            # the instance frames (t, a1, a2 by xyz), row 9 the length
            # (padded with 1.0: the padded r^2 is zero there, and 1/L must
            # stay finite); read by the plain forms and the warped kernels
            geo_np = np.zeros((len(self.edges), 10)
                              + tuple(g + 2 for g in self.grid), np.float64)
            geo_np[:, 9] = 1.0
            for i, e in enumerate(self.edges):
                ext = e["ext"]
                blk = (slice(1, 1 + ext[0]), slice(1, 1 + ext[1]),
                       slice(1, 1 + ext[2]))
                geo_np[(i, slice(0, 9)) + blk] = \
                    e["warp_frames"].reshape(9, *ext)
                geo_np[(i, 9) + blk] = e["warp_L"]
            geoP = tens(geo_np)
        consts = []
        for i, e in enumerate(self.edges):
            if warped:
                # per-INSTANCE geometry fields, views of geoP: frames [3,
                # ext] each, length [ext]; the strain and force arithmetic
                # broadcasts over them
                ext = e["ext"]
                g = geoP[(i, slice(None), slice(1, 1 + ext[0]),
                          slice(1, 1 + ext[1]), slice(1, 1 + ext[2]))]
                frame = (g[0:3], g[3:6], g[6:9], g[9])
            else:
                frame = (tens(e["t"]), tens(e["a1"]), tens(e["a2"]),
                         float(e["L"]))
            # instance-validity masks carry information only under node_keep
            # trimming (every stiffness term is proportional to r^2, which
            # is already zero on invalid cells)
            inst_c = tens(e["inst_valid"]) if self.node_keep is not None \
                else None
            consts.append(frame + (
                e["ca"], e["cb"], e["oa"], e["ob"], e["ext"], e["creators"],
                inst_c))
        valid = tens(self.cell_valid)

        def _b(w):
            """Frame-vector broadcast: template frames are [3] constants,
            warped frames [3, ext] fields; both multiply [*, ext]."""
            return w if w.dim() == 4 else w[:, None, None, None]

        def _padded_r2(radius):
            """Per-geometry squared radii, ghost-padded: [n_geom] of
            [nx+2, ny+2, nz+2] (differentiable in ``radius``)."""
            r = torch.as_tensor(radius, dtype=dt, device=dev)
            r = torch.broadcast_to(r, (self.n_geom, nx, ny, nz))
            out = []
            for g in range(self.n_geom):
                rv = r[g] * valid
                out.append(F.pad(rv * rv, (1, 1, 1, 1, 1, 1)))
            return out

        def _sections(radius):
            """Per-edge per-instance r^2 from the padded per-cell field,
            first-creating cell winning for shared beams."""
            rps2 = _padded_r2(radius)
            out = []
            for (*_frame, ca, cb, oa, ob, ext, creators, inst) in consts:
                r2_inst = None
                for s in creators:  # low->high priority; later overwrites
                    sl = tuple(slice(1 - s[ax], 1 - s[ax] + ext[ax])
                               for ax in range(3))
                    cand = rps2[s[3]][sl]
                    r2_inst = cand if r2_inst is None \
                        else torch.where(cand > 0, cand, r2_inst)
                if r2_inst is None:
                    r2_inst = torch.zeros(ext, dtype=dt, device=dev)
                out.append(r2_inst if inst is None else r2_inst * inst)
            return out

        def _slices(oa, ob, ext):
            sxa = (slice(None),) + tuple(
                slice(oa[ax], oa[ax] + ext[ax]) for ax in range(3))
            sxb = (slice(None),) + tuple(
                slice(ob[ax], ob[ax] + ext[ax]) for ax in range(3))
            return sxa, sxb

        # every per-edge padded r^2 field is a pure 3-D SHIFT of one
        # per-geometry squared base grid: the creator shift s in {0,1}^3
        # and the placement offset (1,1,1) compose into q -> q - s
        _Xp, _Yp, _Zp = (g + 2 for g in self.grid)
        _F2 = _Xp * _Yp * _Zp
        _strides = (_Yp * _Zp, _Zp, 1)
        _prep_mask = None
        if self.node_keep is not None:
            _mask_np = np.zeros((len(consts), _Xp, _Yp, _Zp), np.float64)
            for _e, e in enumerate(self.edges):
                ext = e["ext"]
                _mask_np[_e, 1:1 + ext[0], 1:1 + ext[1], 1:1 + ext[2]] = \
                    e["inst_valid"]
            _prep_mask = tens(_mask_np)
        _maxsh = sum(_strides)                  # covers any s in {0,1}^3

        def prepare_gather(radius):
            """Radius field -> per-edge padded r^2 fields [n_edges, Xp, Yp,
            Zp].  Loop-invariant inside a solve: compute ONCE per radius and
            reuse across every CG/smoother matvec."""
            r = torch.as_tensor(radius, dtype=dt, device=dev)
            r = torch.broadcast_to(r, (self.n_geom, nx, ny, nz))
            flats = []
            for g in range(self.n_geom):
                rv = r[g] * valid
                # cells [1, n] of the padded node grid [n + 3]
                B = F.pad(rv * rv, (1, 2, 1, 2, 1, 2))
                flats.append(F.pad(B.reshape(-1), (_maxsh, _maxsh)))

            def row(s):                          # B[q - s], zeros outside
                sh = sum(int(s[ax]) * _strides[ax] for ax in range(3))
                return flats[s[3]][_maxsh - sh:_maxsh - sh + _F2]

            rows = []
            for (*_f, ext, creators, _iv) in consts:
                cand = None
                for s in creators:   # low->high priority; later overwrites
                    c = row(s)
                    cand = c if cand is None else torch.where(c > 0, c, cand)
                if cand is None:     # creator-less edge (mirrors _sections)
                    cand = torch.zeros(_F2, dtype=dt, device=dev)
                rows.append(cand)
            stacked = torch.stack(rows).reshape(len(consts), _Xp, _Yp, _Zp)
            return stacked if _prep_mask is None else stacked * _prep_mask

        _forms = {}

        def _form(grid, fdev):
            """The plain gather form on a ghost-padded ``grid`` on device
            ``fdev`` (built once per grid and device): ``(apply(up, r2ps,
            geo), vjp(lam, up, r2ps, geo))`` with ``up`` the ghost-padded u
            [nc, 6, *grid + 2], ``r2ps`` [n_e, *grid + 2] and ``geo`` the
            padded geometry field (None unwarped).  The whole lattice's
            form reads zero ghosts; a slab's (``slab``) reads its
            neighbours' planes there."""
            key = (tuple(grid), fdev)
            if key in _forms:
                return _forms[key]
            Xp_, Yp_, Zp_ = (g + 2 for g in grid)
            # edge sides (the B1 kernel's table, in the same order): self
            # and other class, flat shifts of the other endpoint and of the
            # instance anchor on the padded grid, frame, length
            recs = edge_sides(self, Yp_, Zp_)
            n_s = len(recs)
            N = int(np.prod(grid))
            tensf = lambda a: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=fdev)
            gx, gy, gz = torch.meshgrid(
                *(torch.arange(1, g + 1, device=fdev) for g in grid),
                indexing="ij")
            q = ((gx * Yp_ + gy) * Zp_ + gz).reshape(1, 1, N)  # interior
            it = lambda key_: torch.tensor([r[key_] for r in recs],
                                           device=fdev)
            k6 = torch.arange(6, device=fdev).reshape(1, 6, 1)
            rows_s = it("cs").reshape(n_s, 1, 1) * 6 + k6
            rows_o = it("co").reshape(n_s, 1, 1) * 6 + k6
            pos_o = q + it("du").reshape(n_s, 1, 1)
            ei_s = it("ei").reshape(n_s, 1)
            pos_r = q[0] + it("dr").reshape(n_s, 1)
            # side A: uB - uA = other - self, force row [-fu, msh - mdf];
            # side B: uB - uA = self - other, force row [fu, msh + mdf]
            sgn = tensf([-1.0 if r["side"] else 1.0 for r in recs]).reshape(
                n_s, 1, 1)
            sgf = -sgn
            class_sides = [[i for i, r in enumerate(recs) if r["cs"] == c]
                           for c in range(self.nc)]
            frames_c = None
            if not warped:
                fr = tensf(np.stack([np.stack([r["t"], r["a1"], r["a2"]])
                                     for r in recs])).reshape(n_s, 3, 3, 1)
                Ls = np.array([r["L"] for r in recs])
                frames_c = (fr[:, 0], fr[:, 1], fr[:, 2],   # [n_s, 3, 1]
                            tensf(1.0 / Ls).reshape(n_s, 1),
                            tensf(0.5 * Ls).reshape(n_s, 1, 1))
            cs_s = it("cs")
            # side s adds its row at interior point p to r^2 position
            # p + dr_s: the 3-D form of dr, -oa on side A and -ob on side B
            r2_at = []
            for r in recs:
                e = self.edges[r["ei"]]
                off = e["ob"] if r["side"] else e["oa"]
                r2_at.append((r["ei"],) + tuple(
                    slice(1 - off[ax], 1 - off[ax] + grid[ax])
                    for ax in range(3)))

            def frames(geo):
                """(t, a1, a2, 1/L, L/2) of every side: the template's
                constants, or on a warped lattice the instance fields read
                at the side's r^2 anchor ([n_s, 3, N] frames, [n_s, N]
                lengths), 1/L and L/2 computed in the dtype as the JAX
                gather form does."""
                if geo is None:
                    return frames_c
                g = geo.reshape(len(consts), 10, -1).transpose(0, 1)[
                    :, ei_s, pos_r]                           # [10, n_s, N]
                t_, a1_, a2_ = (g[0:3].transpose(0, 1),
                                g[3:6].transpose(0, 1),
                                g[6:9].transpose(0, 1))
                L_ = g[9]
                return t_, a1_, a2_, 1.0 / L_, (L_ * 0.5)[:, None]

            dot = lambda V, w: (V * w).sum(1)
            o = lambda s_, w: s_[:, None] * w

            def gather(up, r2ps):
                """Per-side reads: self and other u [n_s, 6, N], r^2
                [n_s, N]."""
                up = up.reshape(self.nc * 6, -1)
                r2 = r2ps.reshape(len(consts), -1)[ei_s, pos_r]
                return up[rows_s, q], up[rows_o, pos_o], r2

            def strains(uS, uO, fr):
                """The six generalized strains of every side [n_s, N]."""
                t_s, a1_s, a2_s, invL_s, _h = fr
                d = sgn * (uO - uS)                          # uB - uA
                du, dth = d[:, :3], d[:, 3:]
                ths = uS[:, 3:] + uO[:, 3:]
                return (dot(du, t_s) * invL_s,
                        dot(du, a1_s) * invL_s - dot(ths, a2_s) * 0.5,
                        dot(du, a2_s) * invL_s + dot(ths, a1_s) * 0.5,
                        dot(dth, t_s) * invL_s,
                        dot(dth, a1_s) * invL_s,
                        dot(dth, a2_s) * invL_s)

            def rows(fr, s0, s1, s2, s3, s4, s5):
                """Force/moment row [n_s, 6, N] of every side from its
                section forces."""
                t_s, a1_s, a2_s, _i, halfL_s = fr
                fu = o(s0, t_s) + o(s1, a1_s) + o(s2, a2_s)
                msh = halfL_s * (o(s2, a1_s) - o(s1, a2_s))
                mdf = o(s3, t_s) + o(s4, a1_s) + o(s5, a2_s)
                return torch.cat([sgf * fu, msh + sgf * mdf], dim=1)

            def apply_p(up, r2ps, geo):
                """Gather-form K.u: every output point SUMS shifted reads.

                For template edge e with cell offsets (oa, ob): the
                instance anchored at g contributes fA at node (g + oa) of
                class ca and fB at (g + ob) of class cb.  Re-indexed by
                output point p:
                  out[ca](p) += fA(uA = u[ca](p), uB = u[cb](p + d),
                                   r2(p - oa))
                  out[cb](p) += fB(uA = u[ca](p - d), uB = u[cb](p),
                                   r2(p - ob))
                with d = ob - oa in {-1,0,1}^3.  The ghost layer keeps
                every read in bounds; on one device out-of-range
                contributions vanish because the padded r2 is zero there.
                All edge sides are evaluated as one batch; each class then
                sums its sides in edge order, side A before side B -- the
                order the B1 kernel keeps.
                """
                uS, uO, r2 = gather(up, r2ps)
                fr = frames(geo)
                e0, e1, e2, e3, e4, e5 = strains(uS, uO, fr)
                S = np.pi * r2
                I = np.pi * r2 * r2 / 4.0
                ES, kGS = E_mod * S, kappa * G_mod * S
                GJ, EI = 2.0 * G_mod * I, E_mod * I
                f_side = rows(fr, ES * e0, kGS * e1, kGS * e2, GJ * e3,
                              EI * e4, EI * e5)
                acc = []
                for sides in class_sides:
                    a = torch.zeros_like(f_side[0])
                    for i in sides:
                        a = a + f_side[i]
                    acc.append(a)
                return torch.stack(acc).reshape((self.nc, 6) + tuple(grid))

            def vjp_p(lam, up, r2ps, geo):
                """r^2-cotangent of sum(lam * apply_p(up, r2ps)) over the
                interior outputs, in closed form: each side's row with the
                section stiffnesses replaced by their r^2-derivatives
                (dS/dr2 = pi, dI/dr2 = pi r2 / 2), dotted with lam at the
                side's output point and added to the r^2 position the side
                read.  Sides are added one at a time, in edge order (side
                A, then B), by slices: a fixed summation order with no
                atomics, so repeats are bitwise equal.  Equal to autograd
                of the gather form to rounding, at every position."""
                uS, uO, r2 = gather(up, r2ps)
                fr = frames(geo)
                e0, e1, e2, e3, e4, e5 = strains(uS, uO, fr)
                dS = np.pi
                dI = (np.pi / 2.0) * r2
                dfs = rows(fr, (E_mod * dS) * e0, (kappa * G_mod * dS) * e1,
                           (kappa * G_mod * dS) * e2,
                           (2.0 * G_mod) * dI * e3, E_mod * dI * e4,
                           E_mod * dI * e5)
                lamS = lam.reshape(self.nc, 6, N)[cs_s]      # [n_s, 6, N]
                per_side = (lamS * dfs).sum(1).reshape((n_s,) + tuple(grid))
                out = torch.zeros(r2ps.shape, dtype=r2ps.dtype,
                                  device=r2ps.device)
                for i, at in enumerate(r2_at):
                    out[at] += per_side[i]
                return out

            _forms[key] = (apply_p, vjp_p)
            return _forms[key]

        _full = _form(self.grid, dev)

        def apply_gather(u, r2ps):
            """The plain gather form of K.u on the whole lattice (zero
            ghosts): ``_form``'s ``apply`` on ``F.pad(u)``."""
            if u.is_cuda:
                matvec.plain_calls += 1
            return _full[0](F.pad(u, (1, 1, 1, 1, 1, 1)), r2ps, geoP)

        def apply_gather_vjp_r2(lam, u, r2ps):
            """r^2-cotangent of sum(lam * apply_gather(u, r2ps)) (``_form``'s
            ``vjp``)."""
            return _full[1](lam, F.pad(u, (1, 1, 1, 1, 1, 1)), r2ps, geoP)

        def diag(radius):
            r2s = _sections(radius)
            out = torch.zeros((self.nc, 6) + self.grid, dtype=dt, device=dev)
            for (t, a1, a2, L, ca, cb, oa, ob, ext, _cr, _iv), r2 in zip(
                    consts, r2s):
                S = np.pi * r2
                I = np.pi * r2 * r2 / 4.0
                ES, kGS = E_mod * S, kappa * G_mod * S
                GJ, EI = 2.0 * G_mod * I, E_mod * I
                invL = 1.0 / L
                t2 = _b(t * t)
                a12 = _b(a1 * a1)
                a22 = _b(a2 * a2)
                d_u = (ES * t2 + kGS * (a12 + a22)) * invL
                d_th = kGS * (a22 + a12) * (L * 0.25) \
                    + (GJ * t2 + EI * (a12 + a22)) * invL
                dvec = torch.cat([d_u, d_th])
                sxa, sxb = _slices(oa, ob, ext)
                out[(ca,) + sxa] += dvec
                out[(cb,) + sxb] += dvec
            return out

        def energy_dr2(uf, r2s):
            """Analytic d(u^T K u)/d(r^2) per edge-template instance:
              dq/dr2 = pi L [E e0^2 + kG (e1^2+e2^2) + G r2 e3^2
                             + E r2 / 2 (e4^2+e5^2)]
            — one elementwise stencil pass over the strains."""
            out = []
            dot = lambda V, w: (V * _b(w)).sum(0)
            for (t, a1, a2, L, ca, cb, oa, ob, ext, _cr, _iv), r2 in zip(
                    consts, r2s):
                invL = 1.0 / L
                sxa, sxb = _slices(oa, ob, ext)
                uA = uf[ca][sxa]
                uB = uf[cb][sxb]
                du = uB[:3] - uA[:3]
                ths = uA[3:] + uB[3:]
                dth = uB[3:] - uA[3:]
                e0 = dot(du, t) * invL
                e1 = dot(du, a1) * invL - dot(ths, a2) * 0.5
                e2 = dot(du, a2) * invL + dot(ths, a1) * 0.5
                e3 = dot(dth, t) * invL
                e4 = dot(dth, a1) * invL
                e5 = dot(dth, a2) * invL
                out.append((np.pi * L) * (
                    E_mod * e0 * e0 + kappa * G_mod * (e1 * e1 + e2 * e2)
                    + G_mod * r2 * e3 * e3
                    + (0.5 * E_mod) * r2 * (e4 * e4 + e5 * e5)))
            return out

        def apply_scatter(u, radius):
            """Scatter-form K.u (JAX ``matvec``, selected there by
            ``PLDSO_MATVEC=scatter``): per template edge, the instance
            anchored at g adds fA at (g + oa) of class ca, then fB at
            (g + ob) of class cb, by slice adds in template-edge order — a
            fixed order with no atomics.  A plain torch form on any
            device; the operator itself is B1."""
            r2s = _sections(radius)
            out = torch.zeros_like(u)
            o_ = lambda s_, w: s_[None] * _b(w)
            dot_ = lambda V, w: (V * _b(w)).sum(0)
            for (t, a1, a2, L, ca, cb, oa, ob, ext, _cr, _iv), r2 in zip(
                    consts, r2s):
                S = np.pi * r2
                I = np.pi * r2 * r2 / 4.0
                ES, kGS = E_mod * S, kappa * G_mod * S
                GJ, EI = 2.0 * G_mod * I, E_mod * I
                invL = 1.0 / L
                sxa, sxb = _slices(oa, ob, ext)
                uA = u[ca][sxa]            # [6, ext]
                uB = u[cb][sxb]
                du = uB[:3] - uA[:3]
                ths = uA[3:] + uB[3:]
                dth = uB[3:] - uA[3:]
                e0 = dot_(du, t) * invL
                e1 = dot_(du, a1) * invL - dot_(ths, a2) * 0.5
                e2 = dot_(du, a2) * invL + dot_(ths, a1) * 0.5
                e3 = dot_(dth, t) * invL
                e4 = dot_(dth, a1) * invL
                e5 = dot_(dth, a2) * invL
                s0, s1, s2 = ES * e0, kGS * e1, kGS * e2
                s3, s4, s5 = GJ * e3, EI * e4, EI * e5
                fu = o_(s0, t) + o_(s1, a1) + o_(s2, a2)
                msh = (L * 0.5) * (o_(s2, a1) - o_(s1, a2))
                mdf = o_(s3, t) + o_(s4, a1) + o_(s5, a2)
                out[(ca,) + sxa] += torch.cat([-fu, msh - mdf])
                out[(cb,) + sxb] += torch.cat([fu, msh + mdf])
            return out

        apply = StencilMatvec(
            self, lambda up, r2ps: _full[0](up, r2ps, geoP),
            lambda lam, up, r2ps: _full[1](lam, up, r2ps, geoP),
            geo=geoP, plain=apply_gather)
        apply.fused = FusedSmoother(self, apply)

        def slab(axis, n, k, device):
            """B1 (B1w, B2, and B3/B4 as ``.fused``) on slab ``k`` of ``n``
            along grid ``axis``, on ``device``: a ``StencilMatvec`` of the
            ``LatticeSlab`` whose grid is the slab's, its plain versions the
            gather form on the slab's ghost-padded planes (built at their
            first call), a warped lattice's geometry rows sliced from the
            padded field with the halo, and the fused smoother routed by
            the whole level (``FusedSmoother``'s ``level``)."""
            size = self.grid[axis]
            if size % n:
                raise ValueError(f"slab: grid axis {axis} of {self.grid} is "
                                 f"not divisible by {n}")
            s = size // n
            grid_k = list(self.grid)
            grid_k[axis] = s
            view = LatticeSlab(self, grid_k)
            geo_k = None if geoP is None else geoP.narrow(
                2 + axis, k * s, s + 2).to(device, copy=True).contiguous()
            mv = StencilMatvec(
                view,
                lambda up, r2ps: _form(grid_k, device)[0](up, r2ps, geo_k),
                lambda lam, up, r2ps: _form(grid_k, device)[1](
                    lam, up, r2ps, geo_k),
                geo=geo_k)
            mv.fused = FusedSmoother(view, mv, level=self)
            return mv

        def matvec(u, radius):
            return apply(u, prepare_gather(radius))

        matvec.prepare = prepare_gather
        matvec.apply = apply
        matvec.apply_gather = apply_gather
        matvec.apply_gather_vjp_r2 = apply_gather_vjp_r2
        matvec.apply_scatter = apply_scatter
        matvec.slab = slab
        # calls of the plain gather form on CUDA tensors (the smoke's
        # references only: the operator itself runs B1 there)
        matvec.plain_calls = 0
        matvec.sections = _sections
        matvec.energy_dr2 = energy_dr2
        return matvec, diag


def make_structured_compliance_step(slat: StructuredLattice,
                                    free_mask: np.ndarray, f_ext: np.ndarray,
                                    u_imposed: Optional[np.ndarray] = None,
                                    objective=None,
                                    tol: float = 1e-6, maxiter: int = 4000,
                                    precond: str = "jacobi",
                                    mg_opts: Optional[dict] = None):
    """Value and gradient of an objective w.r.t. the per-cell radius field.

    ``free_mask``: [nc, X, Y, Z] bool (free nodes) or [nc, 6, X, Y, Z]
    bool (free DOFs); ``f_ext``: [nc, 6, X, Y, Z] applied forces;
    ``u_imposed``: optional nonzero Dirichlet values; ``objective(u, f)``:
    scalar functional (default: compliance sum(f * u)); ``precond``:
    "jacobi" or "mg" (geometric multigrid V-cycle).  The tensors live on
    ``slat.device`` in ``slat.dtype``.

    Returns ``step(radius_field, u0=None, precond_state=None) -> (obj, g,
    u)``, with the gradient chosen as the JAX package chooses it
    (``structured.py:785-824``):

    * analytic (the default for compliance with no imposed displacement):
      the self-adjoint closed form, no adjoint solve;
    * implicit (forced by a custom objective or ``u_imposed``, selected by
      ``PLDSO_GRAD=implicit`` otherwise): autograd through
      ``fem.solve.custom_linear_solve``, one warm-started adjoint CG, and
      B1's VJP for the operator's r^2-dependence;
    * ``PLDSO_SELFADJOINT=1`` (the legacy switch, compliance only):
      self-adjoint, with autograd through ``prepare`` and B1's VJP.

    ``step.precond_state(r)`` gives a frozen multigrid state;
    ``step.raw(radius_field, free, f, u0)`` is the differentiable
    ``(obj, u)``; ``step.batch(radius_fields)`` the value and gradient of
    each of ``[B, ...]`` candidates (cold solves).  ``step.solves()``
    lists the records of the last ``step`` or ``raw`` call's solves.
    After each step ``step.last_solve`` holds the forward solve's CG
    iteration count, recurrence residual norm and convergence flag, and
    ``step.last_adjoint`` the adjoint solve's (None when there was none).
    """
    from ..fem.solve import custom_linear_solve, pcg

    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown precond {precond!r}: use 'jacobi' or 'mg'")

    matvec, diag_fn = slat.make_matvec()
    dev = torch.device(slat.device)
    dt = slat.dtype
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    free_mask = np.asarray(free_mask)
    if free_mask.ndim == 4:            # per-node -> per-DOF
        free_mask = free_mask[:, None]
    f_shape = np.shape(f_ext)
    free = tens(np.ascontiguousarray(np.broadcast_to(free_mask, f_shape),
                                     np.float64))
    f = tens(f_ext)
    u_imp = torch.zeros_like(f) if u_imposed is None else tens(u_imposed)
    default_objective = objective is None
    if objective is None:
        objective = lambda u, f_: torch.sum(f_ * u)

    opts = dict(mg_opts or {})
    power = opts.pop("power_iters", 10)
    mg_hier = None
    if precond == "mg":
        from .multigrid import build_mg_hierarchy
        mg_hier = build_mg_hierarchy(slat, np.broadcast_to(free_mask, f_shape))

    solves = []                        # this call's solves, in order
    # the fused V-cycle's smoothers scale by free / D, so its M is zero on
    # the non-free DOFs: CG preconditioned by it can never reduce a residual
    # there, which a nonzero u_imposed puts into the forward rhs (the JAX
    # package's fused route stalls at |(1 - free) b| / |b| then).  A is the
    # identity on those DOFs, so on this route the solve takes them
    # straight from the rhs and runs CG on the free part alone: the same
    # fixed point, for the forward and the adjoint solve alike.
    fused = mg_hier is not None and (
        opts["fused"] if opts.get("fused") is not None
        else os.environ.get("PLDSO_MG_FUSED", "") in ("1", "force"))

    def _preconditioner(radius_field, free, pstate):
        # the preconditioner never moves the fixed point: detached radii.
        # ``pstate`` may carry a FROZEN earlier design's state
        r = radius_field.detach()
        with torch.no_grad():
            if mg_hier is not None:
                from .multigrid import mg_apply, mg_precond_state
                if pstate is None:
                    pstate = mg_precond_state(mg_hier, r, power_iters=power,
                                              fused=opts.get("fused"))
                return mg_apply(mg_hier, pstate, **opts)
            dg = free * diag_fn(r) + (1.0 - free)
            dg = torch.where(dg == 0, torch.ones_like(dg), dg)
            return lambda r_: r_ / dg

    def _solve(radius_field, free, f, u0, pstate=None):
        aux = matvec.prepare(radius_field)
        K = lambda u: matvec.apply(u, aux)

        def A(u):
            return free * K(free * u) + (1.0 - free) * u

        b = free * f if u_imposed is None \
            else free * (f - K(u_imp)) + (1.0 - free) * u_imp
        M = _preconditioner(radius_field, free, pstate)
        x0 = u0.detach() * free

        def solve_fn(mv, rhs):
            # the warm start moves convergence only, not the fixed point,
            # so the implicit gradient stays exact; the adjoint solve
            # starts from it too, as in JAX
            res = pcg(mv, free * rhs if fused else rhs, M=M, x0=x0,
                      maxiter=maxiter, tol=tol)
            solves.append({"iterations": res.iterations,
                           "residual_norm": res.residual_norm,
                           "converged": res.converged})
            return res.x + (1.0 - free) * rhs if fused else res.x

        u = custom_linear_solve(A, b, solve_fn)
        return free * u + (1.0 - free) * u_imp

    def raw(radius_field, free, f, u0, pstate=None):
        """The differentiable (objective, u) of one design; starts a new
        record of solves (``step.solves()``)."""
        solves.clear()
        u = _solve(radius_field, free, f, u0, pstate)
        return objective(u, f), u

    def _vag(r, u0, pstate=None):
        rf = r.detach().requires_grad_(True)
        with torch.enable_grad():
            obj, u = raw(rf, free, f, u0, pstate)
            (g,) = torch.autograd.grad(obj, rf)
        return obj.detach(), g, u.detach()

    # gradient form, as the JAX package selects it
    sa_eligible = default_objective and u_imposed is None
    grad_mode = os.environ.get("PLDSO_GRAD", "analytic")
    selfadjoint = sa_eligible and os.environ.get("PLDSO_SELFADJOINT") == "1"
    analytic = sa_eligible and not selfadjoint and grad_mode == "analytic"

    def _sa_step(r, u0):
        """Legacy self-adjoint form: g = -d(uf^T K(r) uf)/dr by autograd
        through ``prepare`` and B1's VJP."""
        with torch.no_grad():
            u = _solve(r.detach(), free, f, u0)
            c = torch.sum(f * u)
        uf = free * u
        rf = r.detach().requires_grad_(True)
        with torch.enable_grad():
            q = torch.sum(uf * matvec.apply(uf, matvec.prepare(rf)))
            (g,) = torch.autograd.grad(q, rf)
        return c, -g, u

    def _analytic_grad(radius_field, uf):
        with torch.no_grad():
            dq = matvec.energy_dr2(uf, matvec.sections(radius_field))
        rf = radius_field.detach().requires_grad_(True)
        with torch.enable_grad():
            tot = None
            for d_, r2 in zip(dq, matvec.sections(rf)):
                s = torch.sum(d_ * r2)
                tot = s if tot is None else tot + s
            (g,) = torch.autograd.grad(tot, rf)
        return -g

    def _sa_analytic(r, u0, pstate=None):
        with torch.no_grad():
            u = _solve(r.detach(), free, f, u0, pstate)
            c = torch.sum(f * u)
        return c, _analytic_grad(r, free * u), u

    def _u0(u0):
        return torch.zeros_like(f) if u0 is None \
            else torch.as_tensor(u0, dtype=dt, device=dev)

    @timing.spanned("step")
    def step(radius_field, u0=None, precond_state=None):
        """Returns (objective, grad, u); pass the previous step's u as
        ``u0`` to warm-start the solves, and ``precond_state`` (from
        ``step.precond_state(r)``) to freeze the multigrid state across
        steps — the solve fixed point is unaffected."""
        r = torch.as_tensor(radius_field, dtype=dt, device=dev)
        u0 = _u0(u0)
        solves.clear()
        if precond_state is not None and mg_hier is not None:
            out = _sa_analytic(r, u0, precond_state) if analytic \
                else _vag(r, u0, precond_state)
        elif analytic:
            out = _sa_analytic(r, u0)
        elif selfadjoint:
            out = _sa_step(r, u0)
        else:
            out = _vag(r, u0)
        step.last_solve = solves[0]
        step.last_adjoint = solves[1] if len(solves) > 1 else None
        return out

    if mg_hier is not None:
        from .multigrid import mg_precond_state as _mps

        def precond_state(r):
            with torch.no_grad():
                return _mps(mg_hier, torch.as_tensor(r, dtype=dt, device=dev),
                            power_iters=power, fused=opts.get("fused"))

        step.precond_state = precond_state

    def step_batch(radius_fields):
        """Value and gradient of each design candidate (``[B, Nx, Ny,
        Nz]`` radii), cold-started, by the implicit form; (obj [B],
        grad [B, ...]).  JAX vmaps the same value-and-grad, whose
        while-loop freezes each converged lane: one solve per candidate
        gives the same result."""
        rs = torch.as_tensor(radius_fields, dtype=dt, device=dev)
        cs, gs = [], []
        for rb in rs:
            c, g, _u = _vag(rb, torch.zeros_like(f))
            cs.append(c)
            gs.append(g)
        return torch.stack(cs), torch.stack(gs)

    step.batch = step_batch
    step.raw = raw
    # the value and gradient by the implicit form, whatever the default
    # form (JAX ``step._jitted``): what ``shard_structured_step`` runs
    step.value_and_grad = _vag
    # the last step() or raw() call's solves, in order: the forward, then
    # the adjoint once the gradient was taken
    step.solves = lambda: list(solves)
    step.operands = (free, f)
    step._operands = step.operands      # the JAX step's name for them
    step.matvec = matvec
    step.hierarchy = mg_hier
    step.grad_form = ("analytic" if analytic
                      else "selfadjoint" if selfadjoint else "implicit")
    step.last_solve = None
    step.last_adjoint = None
    # what ``shard_structured_step`` needs to run this step on slabs
    step._parts = {"lattice": slat, "matvec": matvec, "diag": diag_fn,
                   "free": free, "f": f,
                   "u_imposed": None if u_imposed is None else u_imp,
                   "objective": None if default_objective else objective,
                   "tol": tol, "maxiter": maxiter, "hierarchy": mg_hier,
                   "mg_opts": opts, "power": power, "fused": fused}
    return step


def shard_structured_step(step, mesh, axis_name: str = "shard",
                          grid_axis: Optional[int] = None):
    """The structured step on a mesh (JAX ``shard_structured_step``,
    ``structured.py:902-968``; ``parallel.mesh.make_mesh``).

    The nodal fields ``[nc, 6, X, Y, Z]`` are cut along one grid axis into
    ``mesh.shape[axis_name]`` slabs, one on each device of the mesh's first
    row along ``axis_name`` (``parallel.slabs.ShardedStructuredStep``):
    every matvec is a halo exchange and B1 (B1w, B2, B3, B4 where the
    route takes them) per slab, CG's dots and norms are reduced in rank
    order, and the multigrid levels that divide along the axis run on
    slabs, the rest gathered on the mesh's first device.  The radius field
    and the multigrid state stay replicated there.  JAX replicates the step
    over the other axis (``dp``); it runs once here, on row 0, which gives
    the same answer.  Keeps JAX's ``grid_axis`` rule (default: the largest
    grid axis divisible by the mesh axis size) and its ``ValueError``s,
    and runs what JAX's wrapper runs: the implicit-form value and gradient
    (an adjoint solve), with ``precond_state`` freezing the multigrid
    state.  Returns ``sharded_step(radius_field, u0=None,
    precond_state=None) -> (c, g, u)`` with ``u`` a ``parallel.mesh.
    Sharded`` (``u.gather()`` the whole field; it is taken back as
    ``u0``), carrying ``mesh``, ``grid_axis``, ``n_sharded_levels`` and
    the ``ShardedStructuredStep`` as ``runner``.  On a one-shard mesh it
    gives ``step.value_and_grad``'s bits."""
    from .slabs import ShardedStructuredStep

    n_shard = mesh.shape[axis_name]
    free, f = step.operands
    grid = tuple(free.shape[2:])
    if grid_axis is None:
        cands = [ax for ax in np.argsort(grid)[::-1]
                 if grid[ax] % n_shard == 0]
        if not cands:
            raise ValueError(
                f"no grid axis of {grid} divisible by {axis_name}={n_shard}; "
                f"pad the lattice (e.g. nx = k*{n_shard} - 1) or pass "
                f"grid_axis explicitly")
        grid_axis = int(cands[0])
    elif grid[grid_axis] % n_shard != 0:
        raise ValueError(f"grid axis {grid_axis} of {grid} not divisible "
                         f"by {axis_name}={n_shard}")
    devices = mesh.devices[0] if axis_name == "shard" \
        else tuple(row[0] for row in mesh.devices)
    runner = ShardedStructuredStep(step, devices, grid_axis)

    def sharded_step(radius_field, u0=None, precond_state=None):
        out = runner(radius_field, u0, precond_state)
        sharded_step.last_solve = runner.last_solve
        sharded_step.last_adjoint = runner.last_adjoint
        return out

    sharded_step.mesh = mesh
    sharded_step.grid_axis = grid_axis
    sharded_step.runner = runner
    sharded_step.n_sharded_levels = runner.n_sharded
    sharded_step.last_solve = sharded_step.last_adjoint = None
    return sharded_step
