"""The port's figures (roitr_torch/viz) against the JAX package's on the
CPU: for one port dump (eval/tester.py `trim_outputs` + `dump_pair` of a
seeded forward), every view that tests/test_viz.py checks is written by
both packages under the same file names, and each of the port's is a
non-empty PNG (pixels are not compared) or, for the node-correspondence
line set, JAX's .obj byte for byte. Without matplotlib the port's
viz still imports and says what to install when asked to draw.
"""

import os
import sys

import numpy as np
import pytest
import torch

from roitr_torch.data.loader import dict_to_pair
from roitr_torch.eval.tester import DUMP_KEYS, dump_pair, fetch_outputs, load_dump, trim_outputs
from roitr_torch.viz import Visualizer, visualize_feature_space
from roitr_tpu.viz import Visualizer as JaxVisualizer
from roitr_tpu.viz import visualize_feature_space as jax_visualize_feature_space

from torch_parity import one_torch_thread, pair_arrays, port_and_params  # noqa: F401

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def dump_path(tmp_path_factory):
    """One port dump of a seeded pair, with correspondences kept."""
    _, model, _, _ = port_and_params(0, fine_matching_confidence_threshold=0.0)
    arr = pair_arrays(2)
    pair = dict_to_pair(arr)
    with torch.no_grad():
        out = model(pair, with_gt=True)
    data = trim_outputs(fetch_outputs(out, DUMP_KEYS), pair)
    base = str(tmp_path_factory.mktemp("dump") / "0")
    dump_pair(base, data)
    return base + ".pth"


def _draw(viz_cls, feature_space, data, out_dir):
    viz = viz_cls(out_dir)
    src, tgt = data["src_pcd"], data["tgt_pcd"]
    viz.show_alignment(src, tgt, data["rot"], data["trans"])
    viz.show_correspondences(src, tgt, data["src_corr_pts"], data["tgt_corr_pts"], data["rot"],
                             data["trans"])
    owner = np.argmin(((src[:, None] - data["src_nodes"][None]) ** 2).sum(-1), axis=1)
    viz.show_nodes(src, data["src_nodes"], owner)
    viz.show_patch(src, tgt, data["src_nodes"], data["tgt_nodes"], src_patch=src[owner == 0],
                   tgt_patch=tgt[:15])
    n = min(len(data["src_nodes"]), len(data["tgt_nodes"]))
    corr = np.stack([np.arange(n), np.arange(n)], axis=1)
    viz.save_node_correspondences(data["src_nodes"], data["tgt_nodes"], corr,
                                  np.arange(n) % 3 > 0)
    paths = viz.show_dump(data)
    feature_space(src, data["src_point_desc"], tgt, data["tgt_point_desc"],
                  os.path.join(out_dir, "feature_space.png"), max_points=40)
    return paths


def test_port_draws_the_jax_views_of_a_port_dump(dump_path, tmp_path):
    data = load_dump(dump_path)
    assert len(data["src_corr_pts"]) > 0
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = _draw(Visualizer, visualize_feature_space, data, port_dir)
    want = _draw(JaxVisualizer, jax_visualize_feature_space, data, jax_dir)
    assert set(got) == set(want) == {"input", "gt", "corr", "patch"}
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port_dir):
        with open(os.path.join(port_dir, name), "rb") as f:
            body = f.read()
        if name.endswith(".obj"):  # the line set is text: the same bytes
            with open(os.path.join(jax_dir, name), "rb") as f:
                assert body == f.read(), name
        else:
            assert body[:8] == PNG and len(body) > 1000, name
    # a dump's path draws the same views as its dict
    assert Visualizer(str(tmp_path / "by_path")).show_dump(dump_path).keys() == got.keys()


def test_viz_imports_without_matplotlib(monkeypatch, tmp_path):
    """import roitr_torch.viz needs neither matplotlib nor scikit-learn (the
    card machine has neither); drawing says what to install."""
    for name in [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "sklearn")
                 or m.startswith("roitr_torch.viz")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    import roitr_torch.viz as viz

    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(ImportError, match="pip install matplotlib"):
        viz.Visualizer(str(tmp_path)).show_alignment(pts, pts)
    with pytest.raises(ImportError, match="pip install scikit-learn"):
        viz.visualize_feature_space(pts, pts, pts, pts, str(tmp_path / "fs.png"))
