"""matplotlib visualization of lattices, results, and optimization runs.

Covers the reference's LatticePlotting (plotting_lattice.py:21-746: 3D beam
plots colored by radius/material/type, deformed shapes with x5
magnification, BC markers, voxel mode, radius histograms) and
OptimizationPlotter (plotting_lattice_optim.py:16-191: convergence curves
with a density twin axis) as host-side functions over the array model.
Import of matplotlib is deferred so headless pipelines never pay for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["visualize_lattice", "plot_radius_distribution",
           "plot_convergence", "visualize_homogenization_surface",
           "subplot_lattice_hybrid_geometries", "OptimizationPlotter"]

DEFORM_MAGNIFICATION = 5.0  # point.py:76,131-141


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def visualize_lattice(lattice, beam_color_type: str = "radii",
                      deformed_form: bool = False, result=None,
                      magnification: float = DEFORM_MAGNIFICATION,
                      enable_boundary_conditions: bool = False, bc=None,
                      voxel: bool = False, save_path=None, ax=None):
    """3D line plot of the lattice (visualize_lattice parity)."""
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    nodes = lattice.nodes.copy()
    if deformed_form and result is not None:
        nodes = nodes + magnification * np.asarray(result.u)[:, :3]

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    segs = np.stack([nodes[lattice.edges[:, 0]], nodes[lattice.edges[:, 1]]], axis=1)

    if beam_color_type == "radii":
        values = lattice.radius
    elif beam_color_type == "material":
        values = lattice.edge_mat
    elif beam_color_type == "type":
        values = lattice.edge_type
    elif beam_color_type == "cell":
        values = lattice.edge_cell
    else:
        values = np.zeros(lattice.num_edges)
    values = np.asarray(values, dtype=float)
    vmin, vmax = values.min(), values.max()
    norm = (values - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(values)
    colors = plt.cm.viridis(norm)
    ax.add_collection3d(Line3DCollection(segs, colors=colors, linewidths=1.5))

    if voxel:
        # cell bounding boxes as faint outlines
        for o, s in zip(lattice.cell_origin, lattice.cell_size):
            x0, y0, z0 = o; x1, y1, z1 = o + s
            corners = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                                [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
            edges_idx = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                         (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
            box = np.stack([[corners[i], corners[j]] for i, j in edges_idx])
            ax.add_collection3d(Line3DCollection(box, colors="gray",
                                                 linewidths=0.3, alpha=0.3))

    if enable_boundary_conditions and bc is not None:
        fixed_nodes = np.nonzero(bc.fixed.any(axis=1))[0]
        ax.scatter(*nodes[fixed_nodes].T, color="red", s=25, marker="s",
                   label="fixed")
        loaded = np.nonzero((bc.f_applied != 0).any(axis=1))[0]
        if loaded.size:
            ax.scatter(*nodes[loaded].T, color="blue", s=25, marker="^",
                       label="force")
        ax.legend()

    b = lattice.get_lattice_boundary_box()
    ax.set_xlim(b[0], b[1]); ax.set_ylim(b[2], b[3]); ax.set_zlim(b[4], b[5])
    ax.set_box_aspect((b[1] - b[0], b[3] - b[2], max(b[5] - b[4], 1e-9)))
    if save_path:
        plt.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def plot_radius_distribution(lattice, bins: int = 20, save_path=None):
    """Histogram of beam radii (plot_radius_distribution parity)."""
    plt = _mpl()
    fig, ax = plt.subplots()
    ax.hist(lattice.radius, bins=bins, edgecolor="k")
    ax.set_xlabel("beam radius")
    ax.set_ylabel("count")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_convergence(history: Sequence[dict], save_path=None):
    """Objective + density twin-axis convergence plot
    (OptimizationPlotter parity, plotting_lattice_optim.py:116-167)."""
    plt = _mpl()
    its = [h["iteration"] for h in history]
    obj = [h["objective"] for h in history]
    fig, ax1 = plt.subplots()
    ax1.plot(its, obj, "o-", color="tab:blue", label="objective")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("objective", color="tab:blue")
    rho = [h.get("relative_density") for h in history]
    if any(r is not None for r in rho):
        ax2 = ax1.twinx()
        ax2.plot(its, [r if r is not None else np.nan for r in rho], "s--",
                 color="tab:red", label="relative density")
        ax2.set_ylabel("relative density", color="tab:red")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_radius_field(lattice, cell_radii: Optional[np.ndarray] = None,
                      axis: int = 1, layer: int = 0, save_path=None):
    """Heatmap of the per-cell radius field on one grid layer
    (OptimizationPlotter radius-field heatmap parity)."""
    plt = _mpl()
    cr = np.asarray(cell_radii if cell_radii is not None else lattice.cell_radii)
    r = cr.mean(axis=1) if cr.ndim == 2 else cr
    pos = lattice.cell_pos
    sel = pos[:, axis] == layer
    axes2d = [a for a in range(3) if a != axis]
    nx = pos[:, axes2d[0]].max() + 1
    ny = pos[:, axes2d[1]].max() + 1
    grid = np.full((ny, nx), np.nan)
    for p, v in zip(pos[sel], r[sel]):
        grid[p[axes2d[1]], p[axes2d[0]]] = v
    fig, ax = plt.subplots()
    im = ax.imshow(grid, origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, label="cell radius")
    ax.set_title(f"radius field (axis {axis} layer {layer})")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_parity(y_true, y_pred, save_path=None):
    """Surrogate parity plot (evaluate_kriging parity scatter)."""
    plt = _mpl()
    y_true = np.asarray(y_true); y_pred = np.asarray(y_pred)
    fig, ax = plt.subplots()
    ax.scatter(y_true, y_pred, s=12)
    lo, hi = min(y_true.min(), y_pred.min()), max(y_true.max(), y_pred.max())
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_xlabel("exact"); ax.set_ylabel("surrogate")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def visualize_homogenization_surface(C: np.ndarray, n_theta: int = 60,
                                     n_phi: int = 120, save_path=None):
    """Directional stiffness surface E(theta, phi)
    (export_homogenization_surface_paraview / polar figure parity)."""
    plt = _mpl()
    from .fem.homogenization import directional_modulus

    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    E = directional_modulus(np.asarray(C), TH, PH)
    X = E * np.sin(TH) * np.cos(PH)
    Y = E * np.sin(TH) * np.sin(PH)
    Z = E * np.cos(TH)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, Z, facecolors=plt.cm.viridis((E - E.min()) /
                    max(E.max() - E.min(), 1e-12)), linewidth=0)
    ax.set_title("directional Young's modulus")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def subplot_lattice_hybrid_geometries(lattice, explode_voxel: float = 0.0,
                                      rmin: float = 0.025, rmax: float = 0.1,
                                      save_path=None):
    """One voxel subplot per geometry of a hybrid lattice, cells colored by
    that geometry's per-cell radius (subplot_lattice_hybrid_geometries
    parity, plotting_lattice.py:637-700)."""
    plt = _mpl()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    G = lattice.cell_radii.shape[1]
    if G <= 1:
        print("Lattice is not hybrid; only one geometry type found.")
    fig, axs = plt.subplots(1, G, figsize=(5 * G, 5),
                            subplot_kw={"projection": "3d"})
    axs = np.atleast_1d(axs)
    b = lattice.get_lattice_boundary_box()
    mins = np.array([b[0], b[2], b[4]])

    def box_faces(o, s):
        x0, y0, z0 = o; x1, y1, z1 = o + s
        c = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                      [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
        f = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6),
             (1, 2, 6, 5), (0, 3, 7, 4)]
        return [c[list(q)] for q in f]

    for g in range(G):
        ax = axs[g]
        ax.set_axis_off()
        vals = np.clip((lattice.cell_radii[:, g] - rmin) / max(rmax - rmin, 1e-12),
                       0.0, 1.0)
        for ci in range(lattice.num_cells):
            o = lattice.cell_origin[ci].astype(float).copy()
            s = lattice.cell_size[ci].astype(float)
            if explode_voxel:
                o += explode_voxel * (o - mins) / s
            pc = Poly3DCollection(box_faces(o, s), alpha=0.5,
                                  facecolor=plt.cm.coolwarm(vals[ci]),
                                  edgecolor="k", linewidths=0.3)
            ax.add_collection3d(pc)
        ax.set_xlim(b[0], b[1]); ax.set_ylim(b[2], b[3]); ax.set_zlim(b[4], b[5])
        name = lattice.config.geom_types[g] if g < len(lattice.config.geom_types) \
            else f"geometry {g}"
        ax.set_title(name)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


class OptimizationPlotter:
    """Live convergence plot during the design loop (OptimizationPlotter
    parity, plotting_lattice_optim.py:16-167): objective + relative density
    on twin axes, updated per iteration.

    Headless-safe: with a non-interactive backend the figure is only drawn,
    and ``finalize(save_path=...)`` writes it to disk.
    """

    def __init__(self, title: str = "optimization convergence"):
        plt = _mpl()
        self._plt = plt
        self.obj_hist, self.den_hist = [], []
        self.fig, self.ax = plt.subplots(figsize=(7, 4.5))
        self.ax2 = self.ax.twinx()
        (self.line_obj,) = self.ax.plot([], [], "o-", color="tab:blue",
                                        label="objective")
        (self.line_den,) = self.ax2.plot([], [], "s--", color="tab:orange",
                                         label="relative density")
        self.ax.set_xlabel("iteration")
        self.ax.set_ylabel("objective", color="tab:blue")
        self.ax2.set_ylabel("relative density", color="tab:orange")
        self.ax.set_title(title)
        if hasattr(self.fig.canvas, "manager") and plt.isinteractive():
            self.fig.show()

    def update(self, objective: float, density: float = float("nan")):
        self.obj_hist.append(float(objective))
        self.den_hist.append(float(density))
        it = list(range(len(self.obj_hist)))
        self.line_obj.set_data(it, self.obj_hist)
        self.line_den.set_data(it, self.den_hist)
        for ax, vals in ((self.ax, self.obj_hist), (self.ax2, self.den_hist)):
            v = np.asarray(vals, dtype=float)
            v = v[np.isfinite(v)]
            if v.size:
                lo, hi = float(v.min()), float(v.max())
                pad = 0.1 * (hi - lo) if hi > lo else max(abs(lo), 1.0) * 0.2
                ax.set_ylim(lo - pad, hi + pad)
        self.ax.set_xlim(0, max(5, len(it) - 1))
        self.fig.canvas.draw_idle()
        try:
            self.fig.canvas.flush_events()
        except Exception:
            pass

    # signature used by OptimizationProblem drivers (callback=plotter.on_iteration)
    def on_iteration(self, record: dict):
        self.update(record.get("objective", float("nan")),
                    record.get("relative_density") or float("nan"))

    def finalize(self, save_path=None):
        if save_path:
            self.fig.savefig(save_path, dpi=120, bbox_inches="tight")
            self._plt.close(self.fig)
        return self.fig
