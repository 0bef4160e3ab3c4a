"""Single-epoch stereo reconstruction walkthrough: one stereo pair ->
deep matching -> geometric verification -> relative orientation ->
triangulation -> absolute orientation on surveyed targets -> bundle
adjustment -> coloured sparse cloud, on the card:

  python -m icepy4d_tpu_torch.examples.single_epoch_stereo --assets DIR \
      [--out OUT] [--matcher nn|lightglue|superglue|semidense] \
      [--device cpu]

The first two cameras of `DIR/img` are the pair; their surveyed centres
and the targets F2, F12 and F13 are those of the reference season's
config.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.examples import asset_dir

# surveyed camera centres of the reference season (its config.yaml)
CENTERS = ((151.962, 99.065, 91.643), (309.261, 301.051, 135.008))
TARGETS = ["F2", "F12", "F13"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch.examples.single_epoch_stereo")
    ap.add_argument("--assets", required=True,
                    help="asset folder: img/<cam>/, calib/<cam>.txt, "
                         "targets/")
    ap.add_argument("--out", default="res/single_epoch")
    ap.add_argument("--matcher", default="nn",
                    choices=["nn", "lightglue", "superglue", "semidense"])
    ap.add_argument("--superpoint-weights", default=None)
    ap.add_argument("--matcher-weights", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the BundleAdjustment result, or None when too few
    matches survive verification."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    A = asset_dir(args.assets)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from icepy4d_tpu_torch.core import Calibration, EpochDataMap, Targets
    from icepy4d_tpu_torch.core.camera import Camera
    from icepy4d_tpu_torch.io.ply import write_ply
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher,
                                            NearestNeighborMatcher, Quality,
                                            SemiDenseMatcher,
                                            SuperGlueMatcher, TileSelection)
    from icepy4d_tpu_torch.sfm import (AbsoluteOrientation, BAConfig,
                                       BundleAdjustment, RelativeOrientation,
                                       Triangulate)

    # --- 1. data ------------------------------------------------------------
    em = EpochDataMap(A / "img", time_tolerance_sec=1200)
    cams_names = em.cameras
    images = em.get_images(0)
    ims = {c: images[c].value for c in cams_names}
    h, w = ims[cams_names[0]].shape[:2]

    cameras = {}
    cal_width = w
    for c in cams_names:
        cal = Calibration(A / "calib" / f"{c}.txt").to_camera()
        K = np.asarray(cal.K)
        cal_width = cal.width or w   # target CSVs use CALIBRATED pixels
        if cal.width and cal.width != w:           # downscaled frames
            K = K * (w / cal.width)
            K[2, 2] = 1.0
        cameras[c] = Camera.create(width=w, height=h, K=K,
                                   dist=np.asarray(cal.dist))

    # --- 2. matching ----------------------------------------------------------
    opts = {"max_keypoints": 2048}
    if args.superpoint_weights:
        opts["superpoint_weights"] = args.superpoint_weights
    if args.matcher_weights:
        opts[f"{args.matcher}_weights"] = args.matcher_weights
    matcher = {
        "nn": NearestNeighborMatcher,
        "lightglue": LightGlueMatcher,
        "superglue": SuperGlueMatcher,
        "semidense": SemiDenseMatcher,
    }[args.matcher](opts, device=dev)
    matcher.match(
        ims[cams_names[0]], ims[cams_names[1]],
        quality=Quality.HIGH,
        tile_selection=TileSelection.PRESELECTION,
        grid=[2, 3], overlap=100, threshold=2.0,
        geometric_verification=GeometricVerification.PYDEGENSAC,
        save_dir=out)
    mk0, mk1 = matcher.mkpts0, matcher.mkpts1
    print(f"matches after geometric verification: {len(mk0)}")
    if len(mk0) < 8:
        print("too few matches (no pretrained weights?) — stopping here")
        return None

    # --- 3. relative orientation + triangulation ------------------------------
    centers = {c: np.array(xyz, np.float32)
               for c, xyz in zip(cams_names[:2], CENTERS)}
    baseline = float(np.linalg.norm(
        centers[cams_names[0]] - centers[cams_names[1]]))
    rel = RelativeOrientation(
        [cameras[cams_names[0]], cameras[cams_names[1]]], [mk0, mk1],
        device=dev)
    valid = rel.estimate_pose(threshold=2.0, scale_factor=baseline)
    cameras[cams_names[1]] = rel.cameras[1]
    mk0, mk1 = mk0[valid], mk1[valid]
    tri = Triangulate(
        [cameras[cams_names[0]], cameras[cams_names[1]]], [mk0, mk1],
        device=dev)
    pts = tri.triangulate_two_views(
        compute_colors=True, image=ims[cams_names[0]], cam_id=0)
    print(f"triangulated {len(pts)} points")

    # --- 4. absolute orientation on targets -----------------------------------
    targets = Targets(
        im_file_path=[A / "targets" / f"{images[c].path.stem}.csv"
                      for c in cams_names],
        obj_file_path=A / "targets" / "target_world.csv")
    t_world, found = targets.get_object_coor_by_label(TARGETS)
    t_im = [targets.get_image_coor_by_label(found, i)[0] * (w / cal_width)
            for i in range(2)]
    abso = AbsoluteOrientation(
        tuple(cameras[c] for c in cams_names),
        points3d_final=t_world, image_points=tuple(t_im),
        camera_centers_world=tuple(centers[c] for c in cams_names),
        device=dev)
    abso.estimate_transformation_linear(estimate_scale=True)
    pts = abso.apply_transformation(points3d=pts)
    cameras = dict(zip(cams_names, abso.cameras))

    # --- 5. bundle adjustment ---------------------------------------------------
    ba = BundleAdjustment(
        cameras, {cams_names[0]: mk0, cams_names[1]: mk1}, pts,
        marker_image_points=dict(zip(cams_names, t_im)),
        marker_world=t_world, camera_centers=centers,
        cfg=BAConfig(camera_center_sigma_m=0.5, max_iters=60), device=dev)
    res = ba.run()
    print(f"BA: {res.initial_cost:.1f} -> {res.cost:.1f} "
          f"({res.iterations} iters), rmse {res.reprojection_rmse_px:.3f} px")

    # --- 6. export ----------------------------------------------------------------
    write_ply(out / "sparse_cloud.ply", res.points, rgb=tri.colors)
    print(f"sparse cloud -> {out / 'sparse_cloud.ply'}")
    return res


if __name__ == "__main__":
    main()
