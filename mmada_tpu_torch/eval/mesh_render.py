"""Mesh export and rendering for fitted SMPL motions.

Equivalent of the reference's OBJ/render path (visualize/render_mesh.py,
visualize/vis_utils.py npy2obj): write per-frame .obj meshes and render a
turntable-free matplotlib preview (pyrender/OpenGL is unavailable here;
plot_trisurf gives a dependency-free render of the same geometry).
"""

from __future__ import annotations

import os

import numpy as np


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Minimal Wavefront OBJ writer (vis_utils.save_obj analog)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in np.asarray(faces) + 1:  # OBJ is 1-indexed
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def save_obj_sequence(out_dir: str, vertices_seq: np.ndarray,
                      faces: np.ndarray) -> list[str]:
    """Per-frame frame{i:03d}.obj files (render_mesh.py:29-30 layout)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, verts in enumerate(np.asarray(vertices_seq)):
        p = os.path.join(out_dir, f"frame{i:03d}.obj")
        save_obj(p, verts, faces)
        paths.append(p)
    return paths


def render_mesh_frames(
    vertices_seq: np.ndarray,   # (T, V, 3)
    faces: np.ndarray,          # (F, 3)
    out_path: str,
    fps: int = 20,
    elev: float = 120.0,
    azim: float = -90.0,
) -> str:
    """Render the mesh sequence to a GIF with matplotlib plot_trisurf
    (stick-figure sibling: eval/visualize.py). Returns out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    verts = np.asarray(vertices_seq)
    lo, hi = verts.min(axis=(0, 1)), verts.max(axis=(0, 1))
    span = float((hi - lo).max()) or 1.0
    mid = (hi + lo) / 2.0

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")

    def draw(i):
        ax.clear()
        ax.view_init(elev=elev, azim=azim)
        v = verts[i]
        ax.plot_trisurf(
            v[:, 0], v[:, 1], v[:, 2], triangles=np.asarray(faces),
            color=(0.4, 0.55, 0.8, 1.0), edgecolor="none", shade=True,
        )
        for k, m in enumerate(mid):
            getattr(ax, f"set_{'xyz'[k]}lim")(m - span / 2, m + span / 2)
        ax.set_axis_off()

    anim = FuncAnimation(fig, draw, frames=verts.shape[0], interval=1000 / fps)
    anim.save(out_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
