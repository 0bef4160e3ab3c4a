"""Matching IO helpers (counterpart of `icepy4d_tpu/matching/utils.py`):
matched keypoints read back from the text files that
`ImageMatcherBase.save_mkpts_as_txt` writes, and saved to or read from
one `.npz`. Plain numpy: both packages read each other's files."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_matches_from_disk(folder) -> tuple[np.ndarray, np.ndarray]:
    """(mkpts0, mkpts1) float32 from keypoints_0.txt and keypoints_1.txt
    in `folder`."""
    folder = Path(folder)
    mk0, mk1 = (np.loadtxt(folder / f"keypoints_{i}.txt", delimiter=",",
                           ndmin=2).astype(np.float32) for i in (0, 1))
    if len(mk0) != len(mk1):
        raise ValueError("keypoint files disagree on match count")
    return mk0, mk1


def save_matches_as_npz(path, mkpts0, mkpts1, mconf=None) -> None:
    """One compressed `.npz` of float32 mkpts0, mkpts1 and mconf (zeros
    when not given)."""
    np.savez_compressed(path, mkpts0=np.asarray(mkpts0, np.float32),
                        mkpts1=np.asarray(mkpts1, np.float32),
                        mconf=(np.zeros(len(mkpts0), np.float32)
                               if mconf is None
                               else np.asarray(mconf, np.float32)))


def retrieve_matches_from_npz(path):
    """(mkpts0, mkpts1, mconf) from an `.npz` that save_matches_as_npz
    wrote; mconf is None when the file has none."""
    d = np.load(path)
    return (d["mkpts0"], d["mkpts1"],
            d["mconf"] if "mconf" in d.files else None)
