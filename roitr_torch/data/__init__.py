"""roitr_torch.data: see the modules; each mirrors roitr_tpu/data/ of the
same name. `get_dataset` builds a split's dataset from a config."""

import os


def resolve_info_path(relpath: str) -> str:
    """A split-metadata path (e.g. 'configs/tdmatch/3DMatch.pkl'): as given
    when it exists or is absolute (a user's split wins), else the repo's
    vendored copy of the published metadata when that exists."""
    if os.path.exists(relpath) or os.path.isabs(relpath):
        return relpath
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    vendored = os.path.join(repo, relpath)
    return vendored if os.path.exists(vendored) else relpath


def get_dataset(config, mode: str):
    """Dataset of a split, "train" | "val" | "test" (reference
    dataset/dataloader.py:8-30): 3DMatch (`tdmatch`) or 4DMatch
    (`fdmatch`, whose test split is `test_info`, or `val_info` when that
    is empty). Train pairs are augmented; val and test pairs are seeded by
    index."""
    if config.dataset == "tdmatch":
        from roitr_torch.data.tdmatch import TDMatchDataset, load_info

        if mode == "train":
            return TDMatchDataset(load_info(resolve_info_path(config.train_info)), config,
                                  data_augmentation=True)
        if mode == "val":
            return TDMatchDataset(load_info(resolve_info_path(config.val_info)), config,
                                  data_augmentation=False)
        if mode == "test":
            # the reference's test split is configs/tdmatch/<benchmark>.pkl
            # (dataset/dataloader.py:18), vendored in the repo
            info_path = config.test_info or os.path.join("configs", "tdmatch",
                                                         f"{config.benchmark}.pkl")
            return TDMatchDataset(load_info(resolve_info_path(info_path)), config,
                                  data_augmentation=False)
        raise ValueError(f"unknown split {mode!r}")
    if config.dataset == "fdmatch":
        from roitr_torch.data.fdmatch import FDMatchDataset, read_entries

        splits = {"train": config.train_info, "val": config.val_info,
                  "test": config.test_info or config.val_info}
        if mode not in splits:
            raise ValueError(f"unknown split {mode!r}")
        return FDMatchDataset(read_entries(splits[mode], config.root), config,
                              data_augmentation=(mode == "train"))
    raise ValueError(f"unknown dataset {config.dataset!r}")
