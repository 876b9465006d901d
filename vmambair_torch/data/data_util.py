"""Path pairing helpers: folder and meta-info modes.

The port's copy of the disk-backed part of `vmambair_tpu/data/data_util.py`
(the lmdb helpers wait for the lmdb backend): it builds the
[{lq_path, gt_path}] list a paired dataset iterates, and the GT-only list
of the Real-ESRGAN dataset.
"""

from __future__ import annotations

from os import path as osp
from typing import List, Sequence

from ..utils.misc import scandir


def paired_paths_from_folders(folders: Sequence[str], keys: Sequence[str],
                              filename_tmpl: str = "{}") -> List[dict]:
    """Pairs files of N folders by (templated) stem; the LAST folder is
    the reference (GT) one. keys e.g. ('lq', 'gt')."""
    assert len(folders) == len(keys) and len(folders) >= 2
    gt_folder, gt_key = folders[-1], keys[-1]
    input_listings = [list(scandir(f)) for f in folders[:-1]]
    gt_paths = list(scandir(gt_folder))
    for key, listing in zip(keys[:-1], input_listings):
        assert len(listing) == len(gt_paths), (
            f"{key} and {gt_key} have different number of images: "
            f"{len(listing)}, {len(gt_paths)}")
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        entry = {f"{gt_key}_path": osp.join(gt_folder, gt_path)}
        for key, folder, listing in zip(keys[:-1], folders[:-1],
                                        input_listings):
            stem = filename_tmpl.format(basename)
            input_path = osp.join(folder, f"{stem}{ext}")
            if not osp.exists(input_path):
                # tolerate differing extensions
                cands = [p for p in listing
                         if osp.splitext(osp.basename(p))[0] == stem]
                assert cands, f"{stem}{ext} is not in {key} folder"
                input_path = osp.join(folder, cands[0])
            entry[f"{key}_path"] = input_path
        paths.append(entry)
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl="{}") -> List[dict]:
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, "r") as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({
            f"{input_key}_path": osp.join(input_folder, input_name),
            f"{gt_key}_path": osp.join(gt_folder, gt_name),
        })
    return paths


def paths_from_folder(folder) -> List[str]:
    return [osp.join(folder, p) for p in sorted(scandir(folder))]


def paths_from_folder_or_meta(folder, meta_info=None,
                              io_type: str = "disk") -> List[str]:
    """GT-only path list: meta-info lines (their first field) joined to the
    folder, or a folder scan. lmdb keys wait for the lmdb backend."""
    if io_type == "lmdb" or str(folder).endswith(".lmdb"):
        raise NotImplementedError(
            "lmdb datasets are not ported to vmambair_torch yet; use "
            "io_backend type 'disk'")
    if meta_info:
        with open(meta_info) as f:
            return [osp.join(folder, line.split(" ")[0].strip())
                    for line in f if line.strip()]
    return paths_from_folder(folder)
