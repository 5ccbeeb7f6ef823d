"""Descriptor feature-space visualisation via t-SNE colouring.

Counterpart of roitr_tpu/viz/feature_space.py (reference
visualizer/feature_space.py:54-63): embed the point descriptors of both
clouds jointly into 1-D with t-SNE and colour the geometry with it, so
matching regions share colours across clouds. Needs scikit-learn and
matplotlib, imported when called.
"""

from __future__ import annotations

import os

import numpy as np

from roitr_torch.viz.visualizer import pyplot


def embed_tsne(feats: np.ndarray, seed: int = 0) -> np.ndarray:
    """(N, C) -> (N,) 1-D t-SNE embedding normalized to [0, 1]."""
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError("roitr_torch.viz's feature space embeds with scikit-learn's t-SNE, "
                          "which is not installed: pip install scikit-learn") from e

    emb = TSNE(
        n_components=1, perplexity=30, init="random", random_state=seed
    ).fit_transform(np.asarray(feats, np.float64))
    emb = emb[:, 0]
    lo, hi = emb.min(), emb.max()
    return (emb - lo) / max(hi - lo, 1e-12)


def visualize_feature_space(
    src_pcd: np.ndarray,
    src_feats: np.ndarray,
    tgt_pcd: np.ndarray,
    tgt_feats: np.ndarray,
    out_path: str = "viz/feature_space.png",
    max_points: int = 4000,
    seed: int = 0,
) -> str:
    """Joint t-SNE coloring of both clouds' descriptors."""
    rng = np.random.RandomState(seed)

    def sub(p, f):
        if len(p) > max_points:
            sel = rng.permutation(len(p))[:max_points]
            return p[sel], f[sel]
        return p, f

    src_pcd, src_feats = sub(np.asarray(src_pcd), np.asarray(src_feats))
    tgt_pcd, tgt_feats = sub(np.asarray(tgt_pcd), np.asarray(tgt_feats))

    joint = np.concatenate([src_feats, tgt_feats])
    colors = embed_tsne(joint, seed)
    c_src, c_tgt = colors[: len(src_feats)], colors[len(src_feats):]

    plt = pyplot()
    fig = plt.figure(figsize=(14, 7))
    for i, (pts, cols, title) in enumerate(
        [(src_pcd, c_src, "source"), (tgt_pcd, c_tgt, "target")]
    ):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.set_axis_off()
        ax.set_title(title)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.8, c=cols, cmap="turbo",
                   linewidths=0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
