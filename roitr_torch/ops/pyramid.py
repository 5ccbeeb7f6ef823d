"""Geometry prep of one pair on the device.

Counterpart of roitr_tpu/ops/pyramid.py `device_prep_pair`: the normals
that the host pipeline (data/preprocess.py `preprocess_pair`) would have
estimated are estimated on the device instead, from the padded points
alone. The JAX function also builds both clouds' exact FPS/kNN pyramids;
the port's backbone builds that same pyramid inside every forward
(models/backbone.py `_device_fps_pyramids` and its exact `masked_knn`), so
nothing is built here. Packed batches (`build_pyramids_packed`,
`device_prep_packed`) are a later slice of the port.
"""

from __future__ import annotations

from roitr_torch.ops.normals import estimate_normals


def device_prep_pair(pair, cfg, est=(True, True)):
    """PairInputs with normals estimated on the device for the sides `est`
    asks for (source, target); the others keep the normals they carry. The
    source side uses the raw source geometry, as the datasets do (reference
    fdmatch.py:85-90, RIGA_v2.py:62)."""
    k = cfg.normal_knn
    if est[0]:
        pair = pair._replace(src_normals=estimate_normals(pair.src_raw_points, pair.src_count,
                                                          k=k))
    if est[1]:
        pair = pair._replace(tgt_normals=estimate_normals(pair.tgt_points, pair.tgt_count, k=k))
    return pair
