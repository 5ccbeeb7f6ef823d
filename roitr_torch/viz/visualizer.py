"""Matching / registration visualisation (matplotlib, headless).

Counterpart of roitr_tpu/viz/visualizer.py (reference visualizer.py:9-255:
alignment renderings, correspondence lines, patch colouring) without the
Open3D window: figures are written to files. `show_dump` reads the port's
Tester dumps (eval/tester.py). matplotlib is imported when a figure is
drawn, not with the module, so `import roitr_torch.viz` works where it is
not installed (the card machine has neither it nor scikit-learn).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np

SRC_COLOR = "#ff7e0e"
TGT_COLOR = "#1f77b4"


def pyplot():
    """matplotlib.pyplot on the headless Agg backend, or an ImportError
    that says what to install."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("roitr_torch.viz draws with matplotlib, which is not installed: "
                          "pip install matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _scatter(ax, pts, color, size=0.5, alpha=0.6, label=None):
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=size, c=color, alpha=alpha,
               label=label, linewidths=0)


class Visualizer:
    """Renders dumped pairs (the port's eval/tester.py dumps)."""

    def __init__(self, out_dir: str = "viz"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _fig(self):
        fig = pyplot().figure(figsize=(9, 7))
        ax = fig.add_subplot(111, projection="3d")
        ax.set_axis_off()
        return fig, ax

    def show_alignment(
        self,
        src_pcd: np.ndarray,
        tgt_pcd: np.ndarray,
        rot: Optional[np.ndarray] = None,
        trans: Optional[np.ndarray] = None,
        name: str = "alignment",
    ) -> str:
        """Render both clouds, optionally with src moved by (rot, trans)."""
        if rot is not None:
            src_pcd = src_pcd @ np.asarray(rot).T + np.asarray(trans).reshape(1, 3)
        fig, ax = self._fig()
        _scatter(ax, src_pcd, SRC_COLOR, label="source")
        _scatter(ax, tgt_pcd, TGT_COLOR, label="target")
        ax.legend(loc="upper right")
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        pyplot().close(fig)
        return path

    def show_correspondences(
        self,
        src_pcd: np.ndarray,
        tgt_pcd: np.ndarray,
        src_corr: np.ndarray,
        tgt_corr: np.ndarray,
        rot: Optional[np.ndarray] = None,
        trans: Optional[np.ndarray] = None,
        max_lines: int = 200,
        inlier_radius: float = 0.1,
        name: str = "correspondences",
        offset: float = 1.5,
    ) -> str:
        """Side-by-side clouds with correspondence lines; green = inlier
        under the GT transform (when given), red = outlier."""
        span = float(np.ptp(tgt_pcd[:, 0]) if len(tgt_pcd) else 1.0)
        shift = np.array([span * offset, 0.0, 0.0], np.float32)

        fig, ax = self._fig()
        _scatter(ax, src_pcd, SRC_COLOR, alpha=0.3)
        _scatter(ax, tgt_pcd + shift, TGT_COLOR, alpha=0.3)

        n = min(len(src_corr), max_lines)
        sel = np.linspace(0, len(src_corr) - 1, n).astype(int) if len(src_corr) else []
        inlier = None
        if rot is not None and len(src_corr):
            warped = src_corr @ np.asarray(rot).T + np.asarray(trans).reshape(1, 3)
            inlier = np.linalg.norm(warped - tgt_corr, axis=1) < inlier_radius
        for i in sel:
            color = "green" if inlier is None or inlier[i] else "red"
            a, b = src_corr[i], tgt_corr[i] + shift
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c=color, lw=0.4, alpha=0.7)
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        pyplot().close(fig)
        return path

    def show_nodes(
        self,
        points: np.ndarray,
        nodes: np.ndarray,
        point_to_node: Optional[np.ndarray] = None,
        name: str = "nodes",
    ) -> str:
        """Points colored by owning node (patch partition) + node markers."""
        fig, ax = self._fig()
        if point_to_node is not None:
            cmap = pyplot().get_cmap("tab20")
            colors = cmap(np.asarray(point_to_node) % 20)
            ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c=colors,
                       alpha=0.6, linewidths=0)
        else:
            _scatter(ax, points, "#888888")
        ax.scatter(nodes[:, 0], nodes[:, 1], nodes[:, 2], s=30, c="black", marker="*")
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        pyplot().close(fig)
        return path

    def show_patch(
        self,
        src_pcd: np.ndarray,
        tgt_pcd: np.ndarray,
        src_nodes: Optional[np.ndarray] = None,
        tgt_nodes: Optional[np.ndarray] = None,
        src_patch: Optional[np.ndarray] = None,
        tgt_patch: Optional[np.ndarray] = None,
        name: str = "patch",
        offset: float = 1.5,
    ) -> str:
        """Patch-highlight mode (reference visualizer.py:182-226,
        show_pcd_with_nodes_and_one_patch): both clouds side by side with an
        optional matched patch pair highlighted in one shared color and
        optional node markers."""
        span = float(np.ptp(tgt_pcd[:, 0]) if len(tgt_pcd) else 1.0)
        shift = np.array([span * offset, 0.0, 0.0], np.float32)
        fig, ax = self._fig()
        _scatter(ax, src_pcd, SRC_COLOR, alpha=0.25)
        _scatter(ax, tgt_pcd + shift, TGT_COLOR, alpha=0.25)
        if src_nodes is not None:
            ax.scatter(src_nodes[:, 0], src_nodes[:, 1], src_nodes[:, 2],
                       s=25, c="red", marker="*")
        if tgt_nodes is not None:
            tn = tgt_nodes + shift
            ax.scatter(tn[:, 0], tn[:, 1], tn[:, 2], s=25, c="red", marker="*")
        if src_patch is not None and len(src_patch):
            _scatter(ax, src_patch, "#2ca02c", size=6, alpha=1.0, label="patch")
        if tgt_patch is not None and len(tgt_patch):
            _scatter(ax, tgt_patch + shift, "#2ca02c", size=6, alpha=1.0)
        path = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        pyplot().close(fig)
        return path

    def save_node_correspondences(
        self,
        src_nodes: np.ndarray,
        tgt_nodes: np.ndarray,
        corr_indices: np.ndarray,  # (C, 2) [src_node, tgt_node]
        correct_mask: Optional[np.ndarray] = None,  # (C,) bool; None = all
        name: str = "node_corr",
    ) -> Dict[str, str]:
        """Node-correspondence dump (reference visualizer.py:227-311,
        save_gt_correspondences / save_est_correspondences): a PNG with
        matched nodes green / unmatched red, plus a vertex-colored .obj
        line set (green = correct, red = wrong) loadable in any mesh
        viewer — the headless equivalent of the reference's
        write_triangle_mesh + .obj outputs."""
        corr_indices = np.asarray(corr_indices).astype(int)
        if correct_mask is None:
            correct_mask = np.ones(len(corr_indices), bool)
        correct_mask = np.asarray(correct_mask).astype(bool)

        src_matched = np.zeros(len(src_nodes), bool)
        tgt_matched = np.zeros(len(tgt_nodes), bool)
        if len(corr_indices):
            src_matched[corr_indices[:, 0]] = True
            tgt_matched[corr_indices[:, 1]] = True

        span = float(np.ptp(tgt_nodes[:, 0]) if len(tgt_nodes) else 1.0)
        shift = np.array([span * 1.5, 0.0, 0.0], np.float32)
        fig, ax = self._fig()
        for nodes, matched, off in ((src_nodes, src_matched, 0.0),
                                    (tgt_nodes, tgt_matched, shift)):
            pts = nodes + off
            colors = np.where(matched[:, None], [[0.0, 0.8, 0.0]], [[0.9, 0.0, 0.0]])
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=20, c=colors)
        for (i, j), ok in zip(corr_indices, correct_mask):
            a, b = src_nodes[i], tgt_nodes[j] + shift
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                    c="green" if ok else "red", lw=0.5, alpha=0.8)
        png = os.path.join(self.out_dir, f"{name}.png")
        fig.savefig(png, dpi=150, bbox_inches="tight")
        pyplot().close(fig)

        obj = os.path.join(self.out_dir, f"{name}.obj")
        with open(obj, "w") as f:
            for (i, j), ok in zip(corr_indices, correct_mask):
                rgb = (0, 255, 0) if ok else (255, 0, 0)
                for p in (src_nodes[i], tgt_nodes[j]):
                    f.write(f"v {p[0]} {p[1]} {p[2]} {rgb[0]} {rgb[1]} {rgb[2]}\n")
            for k in range(len(corr_indices)):
                f.write(f"l {2 * k + 1} {2 * k + 2}\n")
        return {"png": png, "obj": obj}

    def show_dump(self, data: Union[str, Dict[str, np.ndarray]],
                  prefix: str = "pair") -> Dict[str, str]:
        """Render the standard views for one dumped pair: a dump's path or
        its dict (eval/tester.py `load_dump`)."""
        if isinstance(data, str):
            from roitr_torch.eval.tester import load_dump

            data = load_dump(data)
        out = {}
        out["input"] = self.show_alignment(
            np.asarray(data["src_pcd"]), np.asarray(data["tgt_pcd"]), name=f"{prefix}_input"
        )
        out["gt"] = self.show_alignment(
            np.asarray(data["src_pcd"]), np.asarray(data["tgt_pcd"]),
            data["rot"], data["trans"], name=f"{prefix}_gt_aligned",
        )
        if len(np.asarray(data.get("src_corr_pts", []))):
            out["corr"] = self.show_correspondences(
                np.asarray(data["src_pcd"]), np.asarray(data["tgt_pcd"]),
                np.asarray(data["src_corr_pts"]), np.asarray(data["tgt_corr_pts"]),
                data.get("rot"), data.get("trans"), name=f"{prefix}_corr",
            )
        if all(len(np.asarray(data.get(k, []))) for k in ("src_nodes", "tgt_nodes")):
            from scipy.spatial import cKDTree

            sp, sn = np.asarray(data["src_pcd"]), np.asarray(data["src_nodes"])
            tp, tn = np.asarray(data["tgt_pcd"]), np.asarray(data["tgt_nodes"])
            _, src_owner = cKDTree(sn).query(sp)
            _, tgt_owner = cKDTree(tn).query(tp)
            patch_id = int(np.bincount(src_owner, minlength=len(sn)).argmax())
            if "src_node_desc" in data and "tgt_node_desc" in data:
                sim = np.asarray(data["src_node_desc"])[patch_id] @ np.asarray(
                    data["tgt_node_desc"]).T
                tgt_id = int(np.argmax(sim))
            else:
                tgt_id = 0
            out["patch"] = self.show_patch(
                sp, tp, sn, tn,
                src_patch=sp[src_owner == patch_id],
                tgt_patch=tp[tgt_owner == tgt_id],
                name=f"{prefix}_patch",
            )
        return out
