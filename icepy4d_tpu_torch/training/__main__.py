"""Train SuperPoint, LightGlue or ALIKED, or fine-tune LightGlue on a
season's verified correspondences, and write the checkpoint as the flat
`.npz` both packages load:

    python -m icepy4d_tpu_torch.training superpoint --steps 6000 \
        --out weights/superpoint_synthetic.npz
    python -m icepy4d_tpu_torch.training lightglue --steps 4000 \
        --out weights/lightglue_synthetic.npz
    python -m icepy4d_tpu_torch.training aliked --steps 4000 \
        --out weights/aliked_synthetic.npz
    python -m icepy4d_tpu_torch.training finetune --results-dir res \
        --out weights/lightglue_finetuned.npz

Flags and defaults are those of the JAX package's scripts/train_*.py and
scripts/finetune_lightglue.py, but `--real-image-dir` defaults to none.
Everything runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.models import convert
from icepy4d_tpu_torch.training.synthetic import load_real_patch_pool


def _save(out, tree) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    convert.save_params(out, tree)
    return out


def _superpoint(args, dev) -> None:
    from icepy4d_tpu_torch.training.superpoint_train import (
        homographic_adaptation, train_superpoint)

    params = None
    history = [{"loss": float("nan")}]
    if args.init:
        params = convert.superpoint_state_dict(convert.load_params(args.init))
        print(f"resumed from {args.init}")
    if args.steps > 0:
        params, history = train_superpoint(
            steps=args.steps, batch=args.batch, h=args.height, w=args.width,
            lr=args.lr, seed=args.seed, desc_weight=args.desc_weight,
            params=params, real_image_dir=args.real_image_dir or None,
            real_fraction=args.real_fraction, device=dev)
    if args.adapt_steps and args.real_image_dir:
        # SuperPoint §6: pseudo-label real patches with the stage-1
        # detector aggregated over warps, then retrain on real data
        rng = np.random.default_rng(args.seed + 1)
        pool = load_real_patch_pool(args.real_image_dir)
        print("homographic adaptation: pseudo-labeling "
              f"{args.adapt_patches} real patches...", flush=True)
        real_labeled = homographic_adaptation(
            params, pool, rng, n_patches=args.adapt_patches,
            h=args.height, w=args.width, device=dev)
        print(f"  {int((real_labeled[1] < 64).sum())} pseudo-labels total",
              flush=True)
        params, history = train_superpoint(
            steps=args.adapt_steps, batch=args.batch, h=args.height,
            w=args.width, lr=args.lr * 0.3, seed=args.seed + 2,
            desc_weight=args.desc_weight, params=params,
            real_image_dir=args.real_image_dir, real_fraction=0.7,
            real_labeled=real_labeled, device=dev)
    out = _save(args.out, convert.superpoint_tree_from_state_dict(params))
    print(f"checkpoint -> {out} (final loss {history[-1]['loss']:.4f})")


def _superpoint_extractor(path, max_keypoints, dev):
    from icepy4d_tpu_torch.models import SuperPoint

    return SuperPoint(max_keypoints=max_keypoints,
                      detection_threshold=0.0005, device=dev
                      ).load_state_dict(convert.superpoint_state_dict(
                          convert.load_params(path)))


def _lightglue(args, dev) -> None:
    from icepy4d_tpu_torch.models import LightGlue
    from icepy4d_tpu_torch.training.lightglue_train import (
        evaluate_matching, make_lightglue_dataset, train_lightglue)

    rng = np.random.default_rng(args.seed)
    n_total = args.n_batches + args.eval_batches
    cache = Path(args.dataset_cache) if args.dataset_cache else None
    if cache is not None and cache.exists():
        with np.load(cache) as z:
            ds = {k: z[k] for k in z.files}
        if ds["H"].shape[0] != n_total:
            raise SystemExit(f"cached dataset has {ds['H'].shape[0]} "
                             f"batches, need {n_total}")
        print(f"loaded dataset cache {cache}", flush=True)
    else:
        sp = _superpoint_extractor(args.superpoint, args.max_keypoints, dev)
        pool = (load_real_patch_pool(args.real_image_dir)
                if args.real_image_dir else None)
        print(f"building {args.n_batches}+{args.eval_batches} cached "
              f"batches of {args.batch} pairs ({args.height}x{args.width}, "
              f"{args.max_keypoints} kpts)", flush=True)
        ds = make_lightglue_dataset(
            rng, sp.extract, n_batches=n_total, batch=args.batch,
            h=args.height, w=args.width, real_pool=pool,
            real_fraction=args.real_fraction)
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(cache, **ds)
            print(f"saved dataset cache {cache}", flush=True)
    train_ds = {k: v[:args.n_batches] for k, v in ds.items()}
    eval_ds = {k: v[args.n_batches:] for k, v in ds.items()}

    model = LightGlue(n_layers=args.n_layers, device=dev)
    params = None
    if args.init:
        params = convert.lightglue_params(convert.load_params(args.init))
        print(f"resumed from {args.init}")
    out = Path(args.out)

    def save_intermediate(state, step):
        tmp = _save(out.with_suffix(".tmp.npz"),
                    convert.lightglue_tree_from_state_dict(state))
        tmp.replace(out)
        print(f"checkpointed step {step} -> {out}", flush=True)

    params, _ = train_lightglue(
        model, train_ds, steps=args.steps, lr=args.lr, seed=args.seed,
        params=params, scan_chunk=args.scan_chunk,
        save_fn=save_intermediate, save_every=args.save_every)
    print("held-out:", json.dumps(evaluate_matching(model, None, eval_ds)))
    _save(out, convert.lightglue_tree_from_state_dict(params))
    print(f"saved {out}")


def _aliked(args, dev) -> None:
    from icepy4d_tpu_torch.models import ALIKED
    from icepy4d_tpu_torch.training.aliked_train import train_aliked
    from icepy4d_tpu_torch.training.superpoint_train import (
        lecun_normal_init)

    model = ALIKED(device=dev)
    if args.init:
        model.load_state_dict(convert.aliked_params(
            convert.load_params(args.init)))
    else:
        lecun_normal_init(model.model, args.seed)
    pool = None
    if args.real_image_dir:
        try:
            pool = load_real_patch_pool(args.real_image_dir)
        except FileNotFoundError as e:
            print(f"[train_aliked] no real pool: {e}", file=sys.stderr)
    params = train_aliked(
        model, None, steps=args.steps, batch=args.batch, h=args.height,
        w=args.width, lr=args.lr, seed=args.seed, n_batches=args.n_batches,
        real_pool=pool, real_fraction=args.real_fraction,
        scan_chunk=args.scan_chunk,
        log=lambda m: print(f"[train_aliked] {m}", file=sys.stderr))
    out = _save(args.out, convert.aliked_tree_from_state_dict(params))
    print(json.dumps({"steps": args.steps, "out": str(out)}))


def _finetune(args, dev) -> None:
    from icepy4d_tpu_torch.models import LightGlue
    from icepy4d_tpu_torch.training.lightglue_train import (
        collect_epoch_pairs, evaluate_matching, homography_to_explicit,
        make_correspondence_dataset, make_lightglue_dataset,
        train_lightglue)

    rng = np.random.default_rng(args.seed)
    pairs = collect_epoch_pairs(args.results_dir,
                                image_scale=args.image_scale)
    if not pairs:
        raise SystemExit(f"no usable epoch pairs in {args.results_dir}")
    n_corr = [len(p["corr0"]) for p in pairs]
    print(f"{len(pairs)} epoch pairs, correspondences min/median/max = "
          f"{min(n_corr)}/{int(np.median(n_corr))}/{max(n_corr)}",
          flush=True)
    sp = _superpoint_extractor(args.superpoint, args.max_keypoints, dev)

    def build(pair_list, n_batches):
        return make_correspondence_dataset(
            rng, sp.describe_at, sp.extract, pair_list, n_batches=n_batches,
            batch=args.batch, n_kpts=args.max_keypoints)

    # held out = whole epoch pairs (samples of one pair share its images)
    n_hold = min(args.holdout_pairs, len(pairs) - 1)
    if args.holdout_pairs and n_hold < args.holdout_pairs:
        print(f"only {len(pairs)} pairs: holding out {n_hold}", flush=True)
    if n_hold > 0:
        train_ds = build(pairs[:-n_hold], args.n_batches)
        eval_ds = build(pairs[-n_hold:], args.eval_batches)
        eval_kind = f"held-out ({n_hold} pairs)"
    else:
        train_ds = build(pairs, args.n_batches)
        eval_ds = build(pairs, args.eval_batches)
        eval_kind = "IN-SAMPLE (no holdout pairs)"

    if args.mix_homography > 0:
        pool = (load_real_patch_pool(args.real_image_dir)
                if args.real_image_dir else None)
        homog = homography_to_explicit(make_lightglue_dataset(
            rng, sp.extract, n_batches=args.mix_homography,
            batch=args.batch, h=240, w=320, real_pool=pool), device=dev)
        train_ds = {k: np.concatenate([train_ds[k], homog[k]])
                    for k in train_ds}
        # spread the homography batches evenly through the real ones
        n_real = args.n_batches
        keys = np.concatenate([
            np.arange(n_real, dtype=np.float64),
            (np.arange(args.mix_homography) + 0.5)
            * n_real / args.mix_homography])
        order = np.argsort(keys, kind="stable")
        train_ds = {k: v[order] for k, v in train_ds.items()}
        print(f"mixed in {args.mix_homography} homography batches "
              f"({len(keys)} total)", flush=True)

    model = LightGlue(n_layers=args.n_layers, device=dev)
    params = None
    if args.init:
        params = convert.lightglue_params(convert.load_params(args.init))
        model.load_state_dict(params)
        print(f"fine-tuning from {args.init}")
    out = Path(args.out)

    def write_ckpt(state):
        tmp = _save(out.with_suffix(".tmp.npz"),
                    convert.lightglue_tree_from_state_dict(state))
        tmp.replace(out)

    # keep-best: periodic saves evaluate on the held-out pairs and only
    # an improvement overwrites --out
    keep_best = n_hold > 0 and not args.no_keep_best
    best = {"score": -1.0, "step": None}

    def eval_score():
        rep = evaluate_matching(model, None, eval_ds, filter_threshold=0.0)
        return rep["recall"] + rep.get("precision_labeled",
                                       rep["precision"]), rep

    def save_intermediate(state, step):
        if keep_best:
            score, rep = eval_score()
            print(f"step {step}: held-out recall {rep['recall']:.4f} "
                  f"P_lab {rep.get('precision_labeled', 0.0):.4f}",
                  flush=True)
            if score <= best["score"]:
                return
            best.update(score=score, step=step)
        write_ckpt(state)
        print(f"checkpointed step {step} -> {out}", flush=True)

    before = evaluate_matching(model, None, eval_ds) \
        if params is not None else None
    params, _ = train_lightglue(
        model, train_ds, steps=args.steps, lr=args.lr, seed=args.seed,
        params=params, scan_chunk=args.scan_chunk,
        save_fn=save_intermediate, save_every=args.save_every)
    after = evaluate_matching(model, None, eval_ds)
    if before is not None:
        print(f"{eval_kind} before:", json.dumps(before))
    print(f"{eval_kind} after:", json.dumps(after))
    if keep_best:
        score, _ = eval_score()
        if score > best["score"]:
            best.update(score=score, step=args.steps)
            write_ckpt(params)
        print(f"saved {out} (best held-out checkpoint: step {best['step']})")
    else:
        write_ckpt(params)
        print(f"saved {out}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m icepy4d_tpu_torch.training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    sub = ap.add_subparsers(dest="model", required=True)

    sp = sub.add_parser("superpoint", help="SuperPoint, synthetic stage "
                        "and homographic adaptation")
    sp.add_argument("--steps", type=int, default=6000)
    sp.add_argument("--batch", type=int, default=32)
    sp.add_argument("--height", type=int, default=120)
    sp.add_argument("--width", type=int, default=160)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--desc-weight", type=float, default=1.0)
    sp.add_argument("--out", default="weights/superpoint_synthetic.npz")
    sp.add_argument("--real-image-dir", default="",
                    help="real frames for descriptor-stage warps "
                         "('' disables)")
    sp.add_argument("--real-fraction", type=float, default=0.5)
    sp.add_argument("--adapt-steps", type=int, default=6000,
                    help="stage-2 steps after homographic adaptation "
                         "(0 disables the adaptation round)")
    sp.add_argument("--adapt-patches", type=int, default=384)
    sp.add_argument("--init", default=None,
                    help="resume from an existing checkpoint (.npz)")

    lg = sub.add_parser("lightglue", help="LightGlue, homography stage")
    lg.add_argument("--steps", type=int, default=4000)
    lg.add_argument("--batch", type=int, default=16)
    lg.add_argument("--height", type=int, default=240)
    lg.add_argument("--width", type=int, default=320)
    lg.add_argument("--max-keypoints", type=int, default=512)
    lg.add_argument("--n-layers", type=int, default=9)
    lg.add_argument("--lr", type=float, default=2e-4)
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--n-batches", type=int, default=96,
                    help="cached training batches (on the device)")
    lg.add_argument("--eval-batches", type=int, default=6,
                    help="held-out batches for the final report")
    lg.add_argument("--scan-chunk", type=int, default=200)
    lg.add_argument("--real-image-dir", default="",
                    help="real frames for patch sampling ('' disables)")
    lg.add_argument("--real-fraction", type=float, default=0.7)
    lg.add_argument("--superpoint",
                    default="weights/superpoint_synthetic.npz",
                    help="SuperPoint checkpoint feeding keypoints and "
                         "descriptors")
    lg.add_argument("--init", default=None,
                    help="resume from an existing LightGlue .npz")
    lg.add_argument("--dataset-cache", default=None,
                    help=".npz path: reuse the cached batch set if it "
                         "exists, else build and save it")
    lg.add_argument("--out", default="weights/lightglue_synthetic.npz")
    lg.add_argument("--save-every", type=int, default=1000,
                    help="checkpoint to --out every N steps (0 = only "
                         "at the end)")

    al = sub.add_parser("aliked", help="the ALIKED-style extractor")
    al.add_argument("--steps", type=int, default=4000)
    al.add_argument("--batch", type=int, default=16)
    al.add_argument("--height", type=int, default=240)
    al.add_argument("--width", type=int, default=320)
    al.add_argument("--lr", type=float, default=3e-4)
    al.add_argument("--seed", type=int, default=0)
    al.add_argument("--n-batches", type=int, default=64)
    al.add_argument("--scan-chunk", type=int, default=100)
    al.add_argument("--real-image-dir", default="",
                    help="real frames for homography pairs ('' disables)")
    al.add_argument("--real-fraction", type=float, default=0.5)
    al.add_argument("--init", default=None,
                    help="resume from an existing checkpoint (.npz)")
    al.add_argument("--out", default="weights/aliked_synthetic.npz")

    ft = sub.add_parser("finetune", help="LightGlue on a season's "
                        "verified correspondences")
    ft.add_argument("--results-dir", required=True,
                    help="pipeline results dir (epochs/*/*.pickle)")
    ft.add_argument("--steps", type=int, default=2000)
    ft.add_argument("--batch", type=int, default=8)
    ft.add_argument("--n-batches", type=int, default=48)
    ft.add_argument("--eval-batches", type=int, default=4)
    ft.add_argument("--max-keypoints", type=int, default=512)
    ft.add_argument("--image-scale", type=float, default=0.25,
                    help="downscale factor for the full-size frames")
    ft.add_argument("--lr", type=float, default=5e-5)
    ft.add_argument("--seed", type=int, default=0)
    ft.add_argument("--scan-chunk", type=int, default=100)
    ft.add_argument("--n-layers", type=int, default=9)
    ft.add_argument("--superpoint",
                    default="weights/superpoint_synthetic.npz")
    ft.add_argument("--init", default="weights/lightglue_synthetic.npz",
                    help="checkpoint to fine-tune ('' = fresh init)")
    ft.add_argument("--save-every", type=int, default=500)
    ft.add_argument("--no-keep-best", action="store_true",
                    help="disable keeping the best held-out checkpoint")
    ft.add_argument("--holdout-pairs", type=int, default=1,
                    help="epoch pairs held out of training for the "
                         "before/after evaluation (0 = in-sample)")
    ft.add_argument("--mix-homography", type=int, default=0,
                    help="interleave N homography-supervised batches of "
                         "the same shapes")
    ft.add_argument("--real-image-dir", default="",
                    help="real frames for the homography mix ('' = "
                         "synthetic canvases only)")
    ft.add_argument("--out", default="weights/lightglue_finetuned.npz")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    {"superpoint": _superpoint, "lightglue": _lightglue, "aliked": _aliked,
     "finetune": _finetune}[args.model](args, dev)


if __name__ == "__main__":
    main()
