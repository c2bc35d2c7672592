"""`tools.depth_e2e` (the port of tools/dev/depth_e2e.py) on the CPU at a tiny
size: one synthetic KITTI-format set of 3 frames (make_scene seeds 0-2), an
ENet of widths (8, 16) trained 1 epoch on 3 synthetic 32 × 64 frames, the
factory run under the three depth sources. Each source prints one JSON line
with the factory's Car precision and recall (`factory_quality`, held against
the JAX script's own in test_torch_port_evolve.py); everything is written
under --workdir; the completed maps are the trained net's (neither the gt
nor the sparse maps), and each source leaves one label file per frame.
"""
import json

import numpy as np

from dfu3d_tpu_torch.tools import complete_depth, depth_e2e, train_depth


def test_depth_e2e_three_sources(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    # the CLIs at a tiny size: argparse keeps the last of a repeated flag
    small = ["--widths", "8", "16", "--dtype", "float32"]
    for mod, extra in ((train_depth, ["--synthetic", "3", "--height", "32", "--width", "64"]),
                       (complete_depth, [])):
        monkeypatch.setattr(mod, "main", lambda argv, main=mod.main, extra=extra:
                            main([*argv, *extra, *small]))
    results = depth_e2e.main(["--frames", "1", "--epochs", "1", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["arm"] for x in lines] == ["gt_depth", "sparse_depth", "completed_depth"]
    for line in lines:
        assert line["Car"] == results[line["arm"]]["Car"]
        assert set(line["Car"]) == {"precision", "recall", "tp", "fp", "fn"}
        assert line["Car"]["tp"] + line["Car"]["fn"] > 0
    assert [p.name for p in tmp_path.iterdir()] == ["output"]
    root = tmp_path / "output" / "depth_e2e" / "data"
    ids = sorted(p.stem for p in (root / "velodyne").glob("*.bin"))
    assert len(ids) == 3
    assert sorted(p.stem for p in (root / "label_train").glob("*.txt")) == ids
    assert (tmp_path / "output" / "depth_e2e" / "depth_run" / "best_ckpt.pth").exists()
    for i in ids:
        done, gt = np.load(root / "depth" / f"{i}.npy"), np.load(root / "depth_gt" / f"{i}.npy")
        assert done.shape == gt.shape and np.isfinite(done).all()
        assert not np.array_equal(done, gt) and (done > 0).mean() > 0.5   # dense, not sparse
