"""Concatenate the per-object gt-database .bin clips into one .npy with
offsets (port of tools/process_tools/create_integrated_database.py, the
reference's tool for shared-memory gt sampling).

    python -m dfu3d_tpu_torch.tools.create_integrated_database \\
        --db_info_path data/kitti/kitti_dbinfos_train.pkl --root data/kitti

Writes <db_info stem>_global.npy (every clip's points, in the db infos'
order) and <db_info stem>_global.pkl (the db infos, each with its
`global_data_offset` (start, end) row range), then checks them.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def create_integrated_db(db_info_path, root, num_point_features=4):
    """Returns (the .npy path, the .pkl path)."""
    db_info_path = Path(db_info_path)
    root = Path(root)
    with open(db_info_path, "rb") as f:
        db_infos = pickle.load(f)

    chunks, offset = [], 0
    for infos in db_infos.values():
        for info in infos:
            pts = np.fromfile(str(root / info["path"]), dtype=np.float32).reshape(
                -1, num_point_features)
            info["global_data_offset"] = (offset, offset + len(pts))
            offset += len(pts)
            chunks.append(pts)
    stacked = (np.concatenate(chunks, axis=0) if chunks
               else np.zeros((0, num_point_features), np.float32))

    out_npy = db_info_path.with_name(db_info_path.stem + "_global.npy")
    out_pkl = db_info_path.with_name(db_info_path.stem + "_global.pkl")
    np.save(out_npy, stacked)
    with open(out_pkl, "wb") as f:
        pickle.dump(db_infos, f)
    return out_npy, out_pkl


def verify(db_info_path, root, out_npy, out_pkl, num_point_features=4, num_checks=50):
    """The offsets of up to `num_checks` clips (drawn with seed 0) reproduce
    their source .bin files (the reference's check,
    create_integrated_database.py:58-69); raises AssertionError otherwise."""
    stacked = np.load(out_npy)
    with open(out_pkl, "rb") as f:
        db_infos = pickle.load(f)
    rng = np.random.RandomState(0)
    all_infos = [i for infos in db_infos.values() for i in infos]
    for i in rng.choice(len(all_infos), min(num_checks, len(all_infos)), replace=False):
        info = all_infos[i]
        lo, hi = info["global_data_offset"]
        src = np.fromfile(str(Path(root) / info["path"]), dtype=np.float32).reshape(
            -1, num_point_features)
        if not np.array_equal(stacked[lo:hi], src):
            raise AssertionError(f"{info['path']}: rows {lo}:{hi} of {out_npy} differ")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--db_info_path", required=True)
    parser.add_argument("--root", required=True)
    parser.add_argument("--num_point_features", type=int, default=4)
    args = parser.parse_args(argv)
    out_npy, out_pkl = create_integrated_db(args.db_info_path, args.root,
                                            args.num_point_features)
    verify(args.db_info_path, args.root, out_npy, out_pkl, args.num_point_features)
    print(f"integrated database written: {out_npy} / {out_pkl} (verified)")
    return out_npy, out_pkl


if __name__ == "__main__":
    main()
