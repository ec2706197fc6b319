"""Motion visualization: 3-D stick-figure animations.

Equivalent of the reference's matplotlib GIF renderer
(visualization/plot_3d_global.py) using the HumanML3D/T2M kinematic chains
(utils/paramUtil.py). SMPL mesh fitting (visualize/joints2smpl) depends on
pretrained SMPL body models that cannot ship here; the stick-figure path is
the complete in-repo renderer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# T2M/HumanML3D 22-joint kinematic chains (utils/paramUtil.py
# t2m_kinematic_chain)
T2M_KINEMATIC_CHAIN = [
    [0, 2, 5, 8, 11],
    [0, 1, 4, 7, 10],
    [0, 3, 6, 9, 12, 15],
    [9, 14, 17, 19, 21],
    [9, 13, 16, 18, 20],
]

# KIT 21-joint chains (utils/paramUtil.py kit_kinematic_chain)
KIT_KINEMATIC_CHAIN = [
    [0, 11, 12, 13, 14, 15],
    [0, 16, 17, 18, 19, 20],
    [0, 1, 2, 3, 4],
    [3, 5, 6, 7],
    [3, 8, 9, 10],
]

_COLORS = ["red", "blue", "black", "darkred", "darkblue"]


def plot_3d_motion(
    joints: np.ndarray,                  # (T, J, 3)
    save_path: str,
    kinematic_chain: Optional[Sequence[Sequence[int]]] = None,
    title: str = "",
    fps: int = 20,
    radius: float = 4.0,
):
    """Render a joint trajectory to an animated GIF
    (plot_3d_global.py:11+ equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    chain = kinematic_chain or T2M_KINEMATIC_CHAIN
    data = joints.copy()
    # ground the feet and center the trajectory
    data[..., 1] -= data[..., 1].min()
    traj = data[:, 0, [0, 2]]
    data[..., 0] -= traj[:, 0:1]
    data[..., 2] -= traj[:, 1:2]

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")

    def update(t):
        ax.clear()
        ax.set_xlim3d(-radius / 2, radius / 2)
        ax.set_ylim3d(0, radius)
        ax.set_zlim3d(-radius / 2, radius / 2)
        ax.grid(False)
        ax.set_axis_off()
        ax.view_init(elev=110, azim=-90)
        ax.set_title(title, fontsize=9)
        for i, link in enumerate(chain):
            lw = 4.0 if i < 5 else 2.0
            ax.plot3D(
                data[t, link, 0], data[t, link, 1], data[t, link, 2],
                linewidth=lw, color=_COLORS[i % len(_COLORS)],
            )

    anim = FuncAnimation(fig, update, frames=data.shape[0],
                         interval=1000 / fps)
    anim.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return save_path


def plot_motion_batch(
    batch_joints: np.ndarray,            # (B, T, J, 3)
    save_paths: Sequence[str],
    titles: Optional[Sequence[str]] = None,
    **kwargs,
):
    out = []
    for i, path in enumerate(save_paths):
        title = titles[i] if titles else ""
        out.append(plot_3d_motion(batch_joints[i], path, title=title, **kwargs))
    return out
